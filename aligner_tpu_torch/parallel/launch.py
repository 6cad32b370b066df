"""One process per rank on this host, in a process group over a file store.

`spawn(fn, world_size, args)` starts `world_size` fresh processes (the
"spawn" start method: each imports the package anew, and the caller's
main module without running its `__main__` block), joins each to a
process group through a file store in a temporary directory (no network
port, so concurrent runs cannot collide), runs `fn(rank, *args)` in each
and waits for all of them within a deadline. The arguments are pickled
(`torch.save`) into that directory, which only this process and its
ranks use. CPU ranks (gloo, one intra-op thread each) serve the tests and
the dry run on a machine without cards; CUDA ranks (NCCL) take the card
of their rank. `fn` must be importable by name: a function defined at the
top of a package module.
"""
from __future__ import annotations

import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import init_process_group


def _rank_main(rank: int, fn, world_size: int, tmp: str,
               device_type: str) -> None:
    if device_type == "cpu":
        torch.set_num_threads(1)
    args = torch.load(os.path.join(tmp, "args.pt"), weights_only=False)
    init_process_group(os.path.join(tmp, "store"), rank, world_size,
                       device_type)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, args: tuple = (), *,
          device_type: str = "cpu", timeout: float = 120.0) -> None:
    """Run fn(rank, *args) on `world_size` ranks and return when every rank
    has. Raises RuntimeError when a rank fails (the others are stopped),
    and TimeoutError when the ranks are not done within `timeout` seconds
    (a hung rendezvous or message): every rank is then killed."""
    with tempfile.TemporaryDirectory() as tmp:
        # The arguments go through a file: a large pickle in the pipe would
        # hold each start until its child had imported everything, one
        # child after the other.
        torch.save(args, os.path.join(tmp, "args.pt"))
        ctx = mp.start_processes(
            _rank_main, args=(fn, world_size, tmp, device_type),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(),
                                           0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{fn.__name__} on {world_size} ranks did not end "
                        f"within {timeout:g} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raise RuntimeError(f"{fn.__name__} failed on rank {e.error_index}"
                               f": {e}") from e
        finally:
            for process in ctx.processes:
                if process.is_alive():
                    process.kill()
                process.join()
