"""Sequence-parallel MAS (port of aligner_tpu/parallel/sequence.py).

When one mel sequence outgrows one card's latency budget, the frame axis
is split into n contiguous blocks, one per rank of a mesh axis, and the
sweep's carry travels between them: the forward sweep sends its final
cumulative column ([B or B / M, T_x] float32) to rank r + 1, and the walk
sends the walking token index back to rank r - 1. Everything else is
local. The messages are point-to-point sends on the axis's group; at n = 1
there are none.

The JAX function's two schedules are one loop here, over M microbatches
of the batch:

* M = 1 (`microbatch` None or 1), the gated schedule: each rank sweeps its
  block once, in ring order, waiting for its carry. The JAX form runs
  every round on every device and keeps one, because SPMD code cannot
  wait; a rank here simply blocks in its receive.
* M > 1, the pipelined schedule: microbatch m goes on to the next rank as
  soon as it is done (a non-blocking send), so rank p sweeps m while rank
  p + 1 sweeps m - 1. After a fill of n - 1 microbatches every rank works.

The block sweeps are plain PyTorch, as the JAX function's are lax scans
(`_forward_bits_single`, `_backtrack_single`; no Pallas kernel): the
port's `_forward_block` and `_backtrack_block`, which `mas_plain` runs
over the whole lattice, so the paths are bit-identical to it.

At the main path's shapes batch sharding needs no message and is the
better split; this is for the single sequence too long for one card.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops.mas_kernel import (_backtrack_block, _check_lattice,
                              _forward_block)
from ..ops.mas_reference import MAX_NEG_VAL


def mas_sequence_parallel(value, t_x, t_y, mesh: DeviceMesh,
                          axis: str = "data",
                          microbatch: int | None = None) -> torch.Tensor:
    """Batched MAS with the mel axis split over `axis` of `mesh`.

    value: [B, T_x, T_y], the global lattice on every rank of the axis (T_y
    divisible by the axis size); t_x, t_y: [B] int. microbatch: the number
    of pipeline microbatches (must divide B; None or 1 is the gated
    schedule). Returns the global float32 paths [B, T_x, T_y] on every
    rank, identical to `mas_plain`'s. Both errors raise before any
    message, so that no rank waits on one that raised.
    """
    B, T_x, T_y = value.shape
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if T_y % n != 0:
        raise ValueError(f"T_y={T_y} not divisible by {axis} size {n}")
    M = microbatch if microbatch is not None and microbatch > 1 else 1
    if B % M != 0:
        raise ValueError(f"B={B} not divisible by microbatch={M}")
    value = value.to(torch.float32)
    t_x, t_y = _check_lattice(value, t_x, t_y)
    group = mesh.get_group(axis)
    r = mesh.get_local_rank(axis)
    T_yl, Bm = T_y // n, B // M
    y0 = r * T_yl
    block = value[:, :, y0:y0 + T_yl]
    items = [slice(m * Bm, (m + 1) * Bm) for m in range(M)]
    sends = []

    def receive(shape, dtype, src):
        buf = torch.empty(shape, dtype=dtype, device=value.device)
        dist.recv(buf, src=dist.get_global_rank(group, src), group=group)
        return buf

    def send(tensor, dst):
        sends.append(dist.isend(tensor, dst=dist.get_global_rank(group, dst),
                                group=group))

    bits = []
    for sl in items:
        carry = None
        if r > 0:
            carry = receive((Bm, T_x), torch.float32, r - 1)
        b, carry = _forward_block(block[sl], t_x[sl], t_y[sl], MAX_NEG_VAL,
                                  y0, carry)
        bits.append(b)
        if r < n - 1:
            send(carry, r + 1)
    paths = []
    for sl, b in zip(items, bits):
        index = None
        if r < n - 1:
            index = receive((Bm,), torch.long, r + 1)
        path, index = _backtrack_block(b, t_x[sl], t_y[sl], T_y, y0, index)
        paths.append(path)
        if r > 0:
            send(index, r - 1)
    for work in sends:
        work.wait()
    path = torch.cat(paths, dim=0)
    if n == 1:
        return path
    blocks = [torch.empty_like(path) for _ in range(n)]
    dist.all_gather(blocks, path, group=group)
    return torch.cat(blocks, dim=2)
