"""Host-to-device input pipelining (port of aligner_tpu/data/prefetch.py).

The training loop's per-step host work (numpy -> device copy of the next
batch) serialises with the step unless the copy is issued ahead of time.
`prefetch_to_device` keeps `size` batches in flight: each array is copied
into pinned host memory and sent with `non_blocking=True`, so the copy
runs on the card's copy engine while the current step's kernels run.
"""
from __future__ import annotations

import collections
from collections.abc import Iterable, Iterator

import torch


def _put(batch: dict, device: torch.device) -> dict:
    if device.type == "cuda":
        return {k: torch.as_tensor(v).pin_memory().to(device,
                                                      non_blocking=True)
                for k, v in batch.items()}
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def prefetch_to_device(batches: Iterable[dict], size: int,
                       device) -> Iterator[dict]:
    """Yield batch dicts of tensors on `device` with their copies issued
    `size` batches ahead. A CUDA device gets pinned, non-blocking copies;
    a CPU device plain `.to(device)`."""
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    device = torch.device(device)
    queue = collections.deque()
    it = iter(batches)
    try:
        for _ in range(size):
            queue.append(_put(next(it), device))
    except StopIteration:
        pass
    for batch in it:
        out = queue.popleft()
        queue.append(_put(batch, device))
        yield out
    while queue:
        yield queue.popleft()
