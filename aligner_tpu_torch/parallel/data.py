"""Batch-wide statistics under data parallelism.

The JAX package's sharded step is one program over the global batch, so
GSPMD computes every statistic that spans the batch over all of it. Here
each rank of the mesh's `data` axis runs the model on its own slice, and
`DistributedDataParallel` averages the ranks' gradients. An item mean
(`loss_forward_sum`, `loss_bin`, `loss_mobo`, `loss_rough`) needs nothing
more when every rank holds B / n_data items. A sum normalised by a count
over the batch (the reconstruction loss's frames, RoMo's feasible items)
and a mean over the batch's rows (the silence anchor's target) do: the
models compute them through `batch_mean` and `rows_mean`, which reduce
over the data ranks while a sharded step holds `batch_group`, and
compute them locally, as the models always did, otherwise.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist

_DATA_GROUP: contextvars.ContextVar[dist.ProcessGroup | None] = \
    contextvars.ContextVar("data_group", default=None)


@contextlib.contextmanager
def batch_group(group: dist.ProcessGroup | None):
    """While active, `batch_mean` and `rows_mean` reduce over `group` (the
    mesh's data axis; None: no reduction)."""
    token = _DATA_GROUP.set(group)
    try:
        yield
    finally:
        _DATA_GROUP.reset(token)


def batch_mean(total: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """total / max(count, 1), where `total` is this rank's part of a sum
    over the batch and `count` its part of the count.

    Under `batch_group` the count is summed over the data ranks, and the
    result is scaled by their number n: the ranks' results then average
    to the global value, and the average of their gradients, which DDP
    takes, is the global value's gradient. The count takes no gradient.
    """
    group = _DATA_GROUP.get()
    if group is None:
        return total / count.clamp(min=1)
    count = count.detach().clone()
    dist.all_reduce(count, group=group)
    return total * dist.get_world_size(group) / count.clamp(min=1)


def rows_mean(x: torch.Tensor) -> torch.Tensor:
    """x.mean(dim=0) over the whole batch's rows. Under `batch_group` the
    rows of every data rank count (equal slices), and the result takes no
    gradient."""
    group = _DATA_GROUP.get()
    if group is None:
        return x.mean(dim=0)
    total = x.detach().sum(dim=0)
    dist.all_reduce(total, group=group)
    return total / (x.shape[0] * dist.get_world_size(group))
