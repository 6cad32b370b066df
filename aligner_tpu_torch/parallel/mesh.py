"""Process mesh and sharding rules (port of aligner_tpu/parallel/mesh.py).

The JAX package scales over a `jax.sharding.Mesh` with XLA collectives.
Here one process runs per rank, and the mesh is a
`torch.distributed.device_mesh.DeviceMesh` over an initialised process
group (NCCL for CUDA ranks, gloo for CPU ranks), with the axes:

* ``data``: the batch axis. Each rank takes its contiguous B / n_data
  rows (`batch_sharding`); the train step wraps the model in
  `DistributedDataParallel` over this axis's group, and the batch-wide
  statistics are reduced over it (`parallel.data`). Batch-sharded
  alignment needs no message at all.
* ``model``: the tensor-parallel axis. Embedding tables, conv kernels and
  dense kernels are split on their output channels (`param_spec`) and run
  as column-parallel layers (`parallel.tensor`).

Nothing falls back: a CUDA mesh needs NCCL and an initialised group.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from .tensor import ModelShard, shard_module

AXES = ("data", "model")
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_process_group(store: str, rank: int, world_size: int,
                       device_type: str = "cuda") -> None:
    """Join the default process group through a file store at `store` (a
    path every rank can reach; no network port). CUDA ranks use NCCL and
    take the card of their rank (one host: the rank is the local rank);
    CPU ranks use gloo, and only when the caller asks for "cpu"."""
    if device_type not in BACKENDS:
        raise ValueError(f"device_type must be one of {sorted(BACKENDS)}, "
                         f"got {device_type!r}")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for a CUDA process group; "
                               "ask for device_type='cpu' to run on gloo")
        if not dist.is_nccl_available():
            raise RuntimeError("this torch has no NCCL; a CUDA process "
                               "group does not fall back to gloo")
        torch.cuda.set_device(rank)
    dist.init_process_group(BACKENDS[device_type],
                            init_method=f"file://{os.path.abspath(store)}",
                            rank=rank, world_size=world_size)


def make_mesh(n_data: int | None = None, n_model: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """A ("data", "model") mesh of n_data x n_model ranks over the default
    process group, rank r at (r // n_model, r % n_model). n_data=None takes
    every rank. The group must be initialised with the device type's
    backend (`init_process_group`)."""
    if device_type not in BACKENDS:
        raise ValueError(f"device_type must be one of {sorted(BACKENDS)}, "
                         f"got {device_type!r}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel.mesh.init_process_group)")
    backend = dist.get_backend()
    if backend != BACKENDS[device_type]:
        raise RuntimeError(f"a {device_type} mesh needs the "
                           f"{BACKENDS[device_type]} backend, the process "
                           f"group has {backend}")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    need = n_data * n_model
    if world < need or need == 0:
        raise ValueError(
            f"make_mesh needs {n_data}x{n_model}={need} ranks but only "
            f"{world} are in the process group ({backend}). Start one "
            f"process per rank with world_size >= {need}.")
    if world != need:
        raise ValueError(f"a mesh spans every rank of the process group: "
                         f"{n_data}x{n_model}={need}, world size {world}")
    return DeviceMesh(device_type,
                      torch.arange(need).reshape(n_data, n_model),
                      mesh_dim_names=AXES)


@dataclasses.dataclass(frozen=True)
class MeshSharding:
    """How a tensor sits on a mesh, as DTensor placements over ("data",
    "model"): split on dim 0 over `data` in contiguous blocks in rank
    order (`batch_sharding`), or whole on every rank (`replicated`)."""
    mesh: DeviceMesh
    placements: tuple

    def local(self, x):
        """This rank's rows of a global tensor or array (all of it when
        replicated). Raises ValueError unless the data axis divides its
        leading dim."""
        if not isinstance(self.placements[0], Shard):
            return x
        n = self.mesh.size(0)
        if x.shape[0] % n:
            raise ValueError(f"batch of {x.shape[0]} rows is not divisible "
                             f"by the data axis of {n} ranks")
        rows = x.shape[0] // n
        r = self.mesh.get_local_rank("data")
        return x[r * rows:(r + 1) * rows]

    def distribute(self, local: torch.Tensor) -> DTensor:
        """The global tensor whose slice on this rank is `local`."""
        return DTensor.from_local(local, self.mesh, self.placements,
                                  run_check=False)


def replicated(mesh: DeviceMesh) -> MeshSharding:
    return MeshSharding(mesh, (Replicate(), Replicate()))


def batch_sharding(mesh: DeviceMesh) -> MeshSharding:
    """Shard the leading (batch) axis over ``data``."""
    return MeshSharding(mesh, (Shard(0), Replicate()))


def param_spec(name: str, value: torch.Tensor) -> int | None:
    """Tensor-parallel rule for aligner parameters: the dim of `value` that
    the ``model`` axis splits, or None (replicated).

    The JAX rule (aligner_tpu/parallel/mesh.py, `param_spec`) splits a flax
    `kernel` or `embedding` of two or more dims on its last (output
    channel) axis and replicates the rest. Through models/convert.py's
    name map: a flax conv kernel [k, in, out] or Dense kernel [in, out] is
    the `weight` of a Conv1d [out, in, k] or Linear [out, in], split on dim
    0; the `embedding` [V, H] is an Embedding's `weight` as it is, split on
    dim 1; biases and `pause_key` stay replicated.
    """
    if value.ndim < 2 or not name.endswith("weight"):
        return None
    if name.endswith("embed.weight"):
        return value.ndim - 1
    return 0


def sharded_dims(model: nn.Module, n_model: int) -> dict[str, int | None]:
    """{parameter name: the dim split over n_model ranks, or None}:
    `param_spec`, with a parameter whose dim does not divide by n_model
    replicated instead."""
    dims = {}
    for name, p in model.named_parameters():
        dim = param_spec(name, p)
        dims[name] = None if dim is None or p.shape[dim] % n_model else dim
    return dims


def shard_params(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Split the model's parameters over the mesh's ``model`` axis by
    `sharded_dims` (each sharded layer keeps its rank's rows and runs as a
    column-parallel layer) and return the model. At a model axis of 1 the
    model is left as it is."""
    n = mesh.size(1)
    if n == 1:
        return model
    group = mesh.get_group("model")
    rank = mesh.get_local_rank("model")
    modules = dict(model.named_modules())
    for name, dim in sharded_dims(model, n).items():
        if dim is not None:
            shard_module(modules[name.rpartition(".")[0]],
                         ModelShard(group, rank, n, dim))
    return model
