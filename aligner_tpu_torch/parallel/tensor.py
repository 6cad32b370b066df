"""Tensor parallelism on the mesh's `model` axis: column-parallel layers.

`parallel.mesh.shard_params` splits a layer's weight on its output
channels (`param_spec`) and marks the layer with a `ModelShard`. Such a
layer computes only the channels of its rank and all-gathers them along
the channel dimension; its bias stays replicated and is added after the
gather. Autograd sees two collectives, as in Megatron-LM's column-parallel
layer (arXiv 1909.08053):

* the input passes through `_CopyToModel`: the identity forward, and an
  all-reduce (sum) of the input gradient backward, since each rank's
  channels give one part of it;
* the output passes through `_GatherFromModel`: an all-gather forward, and
  backward each rank keeps the gradient of its own channels.

So every tensor between the layers, and the gradient of every replicated
parameter, is the same on each rank of the model axis, and a sharded
weight's gradient is the rows of the unsharded gradient.
`torch.distributed.nn.functional.all_gather` sums the output gradient over
the ranks in its backward instead: with the loss computed alike on every
model rank, that would count each gradient once per rank.

Without a shard each helper makes the one call of an unsharded model.
`conv1d`'s call is `ops/conv.py`'s: in float32 on the card while a graph
is built, cuDNN's forward and a backward of cuBLAS GEMMs; in bfloat16,
under `no_grad` and on the CPU, `F.conv1d` forward and backward. A
sharded layer makes the same call on its rank's output channels, without
the bias.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops import conv as conv_ops


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """A layer's slice of the model axis: its rank and the axis size in
    `group`, and the dim of the weight that is split (0 for a Conv1d or
    Linear weight, 1 for an Embedding's)."""
    group: dist.ProcessGroup
    rank: int
    size: int
    dim: int


def model_shard(module: nn.Module) -> ModelShard | None:
    return getattr(module, "model_shard", None)


def shard_module(module: nn.Module, shard: ModelShard) -> None:
    """Keep the rank's rows of `module.weight` (a new parameter) and mark
    the module with `shard`."""
    rows = module.weight.detach().chunk(shard.size, shard.dim)[shard.rank]
    module.weight = nn.Parameter(rows.clone())
    module.model_shard = shard


def param_shards(model: nn.Module) -> dict[str, ModelShard]:
    """{parameter name: shard} of the model's sharded weights."""
    return {(f"{name}." if name else "") + "weight": shard
            for name, module in model.named_modules()
            if (shard := model_shard(module)) is not None}


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard, dim):
        ctx.shard, ctx.dim = shard, dim
        return gather_shards(x, shard, dim)

    @staticmethod
    def backward(ctx, grad):
        rows = grad.chunk(ctx.shard.size, ctx.dim)[ctx.shard.rank]
        return rows.contiguous(), None, None


def gather_shards(x: torch.Tensor, shard: ModelShard,
                  dim: int) -> torch.Tensor:
    """The model axis's slices of a tensor, concatenated along `dim` in
    rank order (no gradient)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(shard.size)]
    dist.all_gather(parts, x, group=shard.group)
    return torch.cat(parts, dim=dim)


def conv1d(conv: nn.Conv1d, x: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """`conv` on x [B, C_in, T] with its weight and bias cast to `dtype`."""
    weight, bias = conv.weight.to(dtype), conv.bias.to(dtype)
    shard = model_shard(conv)
    if shard is None:
        return conv_ops.conv1d(x, weight, bias, conv.padding)
    y = conv_ops.conv1d(_CopyToModel.apply(x, shard.group), weight,
                        padding=conv.padding)
    return _GatherFromModel.apply(y, shard, 1) + bias[:, None]


def linear(layer: nn.Linear, x: torch.Tensor,
           dtype: torch.dtype | None = None) -> torch.Tensor:
    """`layer` on x [..., in], with its weight and bias cast to `dtype`
    when one is given."""
    weight, bias = layer.weight, layer.bias
    if dtype is not None:
        weight, bias = weight.to(dtype), bias.to(dtype)
    shard = model_shard(layer)
    if shard is None:
        return F.linear(x, weight, bias)
    y = F.linear(_CopyToModel.apply(x, shard.group), weight)
    return _GatherFromModel.apply(y, shard, -1) + bias


def embedding(embed: nn.Embedding, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of `embed` for `tokens`, [..., features]."""
    shard = model_shard(embed)
    if shard is None:
        return embed(tokens)
    return _GatherFromModel.apply(F.embedding(tokens, embed.weight), shard,
                                  -1)


def gathered_state_dict(model: nn.Module) -> dict[str, torch.Tensor]:
    """The model's state_dict with each weight split over the model axis
    gathered whole (a collective on every rank of the axis)."""
    state = model.state_dict()
    for name, shard in param_shards(model).items():
        state[name] = gather_shards(state[name], shard, shard.dim)
    return state
