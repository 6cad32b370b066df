"""Host-to-device input pipelining (port of aligner_tpu/data/prefetch.py).

The training loop's per-step host work (numpy -> device copy of the next
batch) serialises with the step unless the copy is issued ahead of time.
`prefetch_to_device` keeps `size` batches in flight: each array is copied
into pinned host memory and sent with `non_blocking=True`, so the copy
runs on the card's copy engine while the current step's kernels run.
With a `sharding` (`parallel.batch_sharding`) only the rank's rows are
copied, and each yields as the global DTensor the sharded step takes, as
the JAX package's `sharding` places each array on the mesh.
"""
from __future__ import annotations

import collections
from collections.abc import Iterable, Iterator

import torch


def _put(batch: dict, device: torch.device, sharding) -> dict:
    if sharding is not None:
        batch = {k: sharding.local(v) for k, v in batch.items()}
    if device.type == "cuda":
        out = {k: torch.as_tensor(v).pin_memory().to(device,
                                                     non_blocking=True)
               for k, v in batch.items()}
    else:
        out = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    if sharding is not None:
        out = {k: sharding.distribute(v) for k, v in out.items()}
    return out


def prefetch_to_device(batches: Iterable[dict], size: int, device,
                       sharding=None) -> Iterator[dict]:
    """Yield batch dicts of tensors on `device` with their copies issued
    `size` batches ahead. A CUDA device gets pinned, non-blocking copies;
    a CPU device plain `.to(device)`. sharding: a `parallel.MeshSharding`;
    each array's rows of this rank are copied, and yielded as DTensors on
    its mesh (None: whole tensors). The DTensor is there for parity with
    the JAX package, whose sharded batch is one global array: its
    `full_tensor()` is the whole batch, while the sharded step reads only
    its local rows."""
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    device = torch.device(device)
    queue = collections.deque()
    it = iter(batches)
    try:
        for _ in range(size):
            queue.append(_put(next(it), device, sharding))
    except StopIteration:
        pass
    for batch in it:
        out = queue.popleft()
        queue.append(_put(batch, device, sharding))
        yield out
    while queue:
        yield queue.popleft()
