"""The port's twin of the JAX package's `__graft_entry__.py`: a forward
step to run, and a dry run of the sharded training step on CPU ranks.

    python -m aligner_tpu_torch.graft_entry [--device cuda]

`entry(device)` returns (fn, example_args): the OTA aligner's forward at
vocab 100, dim 96, hidden 128 on a seeded batch of 8 items, 64 tokens x
256 frames, through `torch.func.functional_call`, so `fn` takes the
parameters as its first argument as the JAX function takes its param tree.
On a CUDA device it launches kernels H1 (MAS) and H2 (forward-sum).

`dryrun_multichip(n)` is the JAX dry run's virtual CPU mesh in processes:
n gloo ranks on the CPU (no card needed) build an n_data x n_model mesh
(n_model = 2 when n is even) and take one data- and tensor-parallel train
step each of the pause-blind OTA, the pause-aware OTA with its
reconstruction and MoBo, then run sequence-parallel MAS over all n ranks,
gated and with 2 microbatches, bit-identical to `mas_plain`. It prints
the JAX dry run's summary line and raises if a rank fails.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from .models import MoBoAligner, MoBoConfig, OTAAligner, OTAConfig
from .ops.mas_kernel import mas_plain
from .parallel import make_mesh, mas_sequence_parallel
from .parallel.launch import spawn
from .train.step import create_train_state, make_train_step

DRYRUN_SECONDS = 300.0


def _example_batch(B, T_x, T_y, n_mels, vocab, seed=0) -> dict:
    """The JAX entry's seeded batch, as numpy arrays."""
    rng = np.random.default_rng(seed)
    return {
        "tokens": rng.integers(1, vocab, (B, T_x)).astype(np.int32),
        "mel": rng.standard_normal((B, T_y, n_mels)).astype(np.float32),
        "text_lengths": np.clip(rng.integers(T_x // 2, T_x + 1, B), 1,
                                T_x).astype(np.int32),
        "mel_lengths": np.clip(rng.integers(T_y // 2, T_y + 1, B), T_x,
                               T_y).astype(np.int32),
    }


def entry(device="cuda"):
    """(fn, example_args): the forward of the flagship model, the OTA
    aligner with MAS binarisation inside, on `device` (a CUDA device
    launches the kernels; "cpu" runs their plain versions).
    fn(params, tokens, mel, text_lengths, mel_lengths) returns
    (loss_forward_sum, loss_bin, durations)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; entry(device='cpu') runs the "
                           "kernels' plain versions")
    cfg = OTAConfig(vocab_size=100, dim=96, hidden=128)
    model = OTAAligner(cfg, device=device)
    batch = _example_batch(8, 64, 256, cfg.n_mels, cfg.vocab_size)
    params = {k: v.detach() for k, v in model.named_parameters()}

    def fn(params, tokens, mel, text_lengths, mel_lengths):
        out = functional_call(model, params,
                              (tokens, mel, text_lengths, mel_lengths))
        return out["loss_forward_sum"], out["loss_bin"], out["durations"]

    example_args = (params, *(torch.from_numpy(batch[k]).to(device)
                              for k in ("tokens", "mel", "text_lengths",
                                        "mel_lengths")))
    return fn, example_args


def _one_step(model, mesh, batch, **step_kw) -> float:
    state = create_train_state(model, learning_rate=1e-3, mesh=mesh)
    _, metrics = make_train_step(model, mesh, **step_kw)(state, batch)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite {type(model).__name__} loss in "
                             f"the dry run")
    return loss


def _dryrun_rank(rank: int, n: int, out: str) -> None:
    n_model = 2 if n % 2 == 0 else 1
    n_data = n // n_model
    mesh = make_mesh(n_data, n_model, device_type="cpu")
    batch = _example_batch(2 * n_data, 16, 48, 80, 50)
    loss = _one_step(OTAAligner(OTAConfig(vocab_size=50, dim=32,
                                          hidden=48)), mesh, batch)
    # the pause-aware (skip-lattice) model and a MoBo objective step
    # through the same data x model mesh
    pause_loss = _one_step(OTAAligner(OTAConfig(
        vocab_size=50, dim=32, hidden=48, model_pauses=True,
        use_recon=True)), mesh, batch)
    mobo_loss = _one_step(
        MoBoAligner(MoBoConfig(vocab_size=50, dim=24, hidden=32,
                               max_duration=8)), mesh, batch,
        objective=lambda out, _: (out["loss_mobo"], {}))

    # sequence-parallel MAS: the mel axis over every rank, the carry
    # passed on by messages (on top of the data x model step above)
    sp_mesh = make_mesh(n, 1, device_type="cpu")
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.standard_normal((2, 8, 8 * n))
                         .astype(np.float32))
    tx = torch.tensor([8, 5], dtype=torch.int32)
    ty = torch.tensor([8 * n, 5 * n], dtype=torch.int32)
    want = mas_plain(v, tx, ty)
    if not torch.equal(mas_sequence_parallel(v, tx, ty, sp_mesh), want):
        raise AssertionError("sequence-parallel MAS diverged from "
                             "single-process")
    if not torch.equal(mas_sequence_parallel(v, tx, ty, sp_mesh,
                                             microbatch=2), want):
        raise AssertionError("overlapped sequence-parallel MAS diverged "
                             "from single-process")
    if dist.get_rank() == 0:
        shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
        with open(out, "w") as f:
            f.write(f"dryrun_multichip ok: mesh={shape} loss={loss:.4f} "
                    f"pause_loss={pause_loss:.4f} "
                    f"mobo_loss={mobo_loss:.4f}; seq-parallel MAS over {n} "
                    f"devices bit-identical (gated + overlapped)\n")


def dryrun_multichip(n_devices: int) -> None:
    """Run the dry run on `n_devices` gloo ranks on the CPU and print its
    summary line; raises if a rank fails or the ranks do not end within
    DRYRUN_SECONDS."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "summary.txt")
        spawn(_dryrun_rank, n_devices, (n_devices, out),
              timeout=DRYRUN_SECONDS)
        with open(out) as f:
            print(f.read(), end="", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dryrun_multichip(8)
    fn, example_args = entry(args.device)
    print("entry ok:", float(fn(*example_args)[0]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
