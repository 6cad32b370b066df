"""Batch alignment serving with the PyTorch port on the card.

The twin of examples/batch_serving.py. A serving loop produces the
log-likelihood lattice in the layout its producer writes naturally,
frame-major ([B, T_mel, T_text], e.g. `torch.einsum("byd,bxd->byx", ...)`),
and hands it to `mas_path(..., frame_major=True)` as a transposed view:
kernel H1 reads the lattice through its strides, so nothing is
transposed in memory. Durations are the path's sum over frames. The time
is the card's device time per batch (`measure_device_time`), which does
not move with the host's load.

    python examples/batch_serving_torch.py [--batch 256] [--device cuda]

With `--device cpu` it runs the kernel's plain version and reports the
host time of the CPU operators; there is no fallback from cuda to cpu.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--t-text", type=int, default=128)
    ap.add_argument("--t-mel", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from aligner_tpu_torch.ops.mas_kernel import mas_path
    from aligner_tpu_torch.utils.profiling import measure_device_time

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run the "
                         "plain version on the CPU")
    B, T_x, T_y = args.batch, args.t_text, args.t_mel
    rng = np.random.default_rng(0)
    # In a real service this is the model's log-likelihood lattice.
    value_fm = torch.from_numpy(
        rng.standard_normal((B, T_y, T_x)).astype(np.float32)).to(device)
    t_x_np = rng.integers(T_x // 2, T_x + 1, B)
    t_y_np = np.maximum(t_x_np, rng.integers(T_y // 4, T_y + 1, B))
    t_x = torch.from_numpy(t_x_np.astype(np.int32)).to(device)
    t_y = torch.from_numpy(t_y_np.astype(np.int32)).to(device)

    def align(value_fm, t_x, t_y):
        path = mas_path(value_fm.transpose(1, 2), t_x, t_y,
                        frame_major=True)            # [B, T_y, T_x]
        return path.sum(1)                           # durations [B, T_x]

    durations = align(value_fm, t_x, t_y)
    assert (durations.sum(-1).cpu().numpy() == t_y_np).all()

    t = measure_device_time(align, value_fm, t_x, t_y, iters=args.iters)
    if device.type == "cuda":
        where = f"device time on {torch.cuda.get_device_name(device)}"
    else:
        where = "host time of the plain version on the CPU"
    print(f"B={B} T_text={T_x} T_mel={T_y}: {t * 1e3:.3f} ms/batch, "
          f"{B / t:,.0f} paths/s ({where})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
