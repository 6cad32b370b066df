"""Smoke run of aligner_tpu_torch on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Builds the package's CUDA kernels from `aligner_tpu_torch/csrc/` with nvcc
(sm_90a), holds each against its plain PyTorch version on the card, then
drives the two main paths through the public entry points and checks that
every kernel of each path was launched there: serving (`maximum_path`,
`OTAAligner` at the CLI's default width, `BatchAligner`) and training
(`train_aligner` at the same width, checkpoints, `demo-ota`). Phases:

  1. the card (nvidia-smi name and power limit)
  2. kernel build
  3. H1 (MAS) against mas_plain and the numpy oracle, bit-identical
  4. H2 (forward-sum alpha) against alpha_plain, rtol 1e-5
  5. serving path: maximum_path, OTA forward, BatchAligner; launch counts
  6. the serving path's results against the plain route
  7. CUDA-event times of each kernel against its plain version
  8. H3 (forward-sum beta/posterior) against gamma_plain, rtol 1e-5 /
     atol 1e-6, and the loss gradient on the card against the plain one
  9. training path: train_aligner at B=16 on a synthetic corpus, launch
     counts, checkpoint restore and a resumed step, parameter gradients
     against a CPU copy, step times at B=16 and at B=64 x 2048 frames
 10. `python -m aligner_tpu_torch demo-ota --device cuda` as a subprocess

The second-to-last line is a JSON object listing the kernels; the last is
{"ok": true, "device": {...}}. Any failed check raises, and the script
exits non-zero without a result; so it does without a CUDA device, or
without the package beside it. Nothing runs on the CPU in its place; the
one CPU run is phase 9's reference gradient.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

B_MAS, T_X, T_Y = 32, 128, 1024          # headline MAS shape (bench.py)
B_OTA = 16                               # OTA/forward-sum batch
LONG_T_Y = 8192                          # long-form lattice length
VOCAB, N_MELS, DIM, HIDDEN = 76, 80, 192, 256   # train/align CLI defaults
FS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6
TRAIN_STEPS, TRAIN_UTTERANCES, LR = 20, 224, 1e-3
BIN_START, BIN_RAMP = 10, 100            # bin loss switched on mid-run
B_LONG, T_Y_LONG = 64, 2048              # BASELINE.json config 5
# Card vs CPU parameter gradients of the whole model. The float32
# forward-backward sweeps round alpha and beta near |total| ~ 4e3 (an ulp
# of 2.4e-4 to 4.9e-4) before exp(alpha + beta - total), so a change in
# the lattice's last bits (the encoders' float32 sums, the prior's lgamma
# on the card against the CPU's) moves these gradients by about 1e-3
# (PERF.md, training-slice findings); even one lattice through the plain
# versions on the CPU (its own exp and log1p) moves gamma by up to an ulp
# of |alpha|. The kernels are held to GRAD_RTOL/GRAD_ATOL against the
# plain versions on the card, on the same lattice.
GRAD_REL_LIMIT = 1e-2
DEMO_STEPS = 30


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def ragged(seed, B, T_x, T_y):
    """Ragged lattice batch made the way bench.py makes its input."""
    rng = np.random.default_rng(seed)
    value = (rng.standard_normal((B, T_x, T_y)) * 3).astype(np.float32)
    t_x = rng.integers(max(1, T_x // 2), T_x + 1, B).astype(np.int32)
    t_y = np.maximum(t_x, rng.integers(max(1, T_y // 4), T_y + 1, B)) \
        .astype(np.int32)
    return value, t_x, t_y


def require_equal(name, got, want):
    if not torch.equal(got, want):
        bad = (got != want).nonzero()
        raise AssertionError(f"{name}: {bad.shape[0]} cells differ, first "
                             f"at {bad[:4].tolist()}")


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    log(1, f"torch {torch.__version__} cuda {torch.version.cuda}; "
           f"device 0: {torch.cuda.get_device_name(0)}; "
           f"count {torch.cuda.device_count()}")
    return card


def phase_build():
    from aligner_tpu_torch import _build
    t0 = time.perf_counter()
    _build.load_library()
    log(2, f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
           f"(nvcc {_build.BUILD_INFO['seconds']:.1f} s)")
    for line in _build.BUILD_INFO["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(2, "ptxas: " + line.strip())


def phase_mas(dev):
    from aligner_tpu_torch.ops.mas_kernel import (mas_durations, mas_path,
                                                  mas_plain)
    from aligner_tpu_torch.ops.mas_reference import mas_single
    max_err = 0.0
    for seed in (0, 1):
        value, t_x, t_y = ragged(seed, B_MAS, T_X, T_Y)
        if seed == 1:           # contract edges: t_x > t_y, and t_x = 0
            t_x[0], t_y[0] = T_X, T_X // 2
            t_x[1], t_y[1] = 0, T_Y // 2
        v = torch.from_numpy(value).to(dev)
        tx = torch.from_numpy(t_x).to(dev)
        ty = torch.from_numpy(t_y).to(dev)
        path = mas_path(v, tx, ty)
        want = mas_plain(v, tx, ty)
        torch.cuda.synchronize()
        require_equal(f"H1 seed {seed} vs mas_plain", path, want)
        max_err = max(max_err, (path - want).abs().max().item())
        if seed == 1 and path[:2].any():
            raise AssertionError("H1: invalid items must get zero paths")
        for i in range(2, 6):
            oracle = mas_single(value[i].copy(), int(t_x[i]), int(t_y[i]))
            if not np.array_equal(path[i].cpu().numpy().astype(np.int32),
                                  oracle):
                raise AssertionError(f"H1 seed {seed} item {i} vs oracle")
        require_equal(f"H1 seed {seed} durations mode",
                      mas_durations(v, tx, ty),
                      path.sum(-1).to(torch.int32))
        fm = mas_path(v.transpose(1, 2).contiguous().transpose(1, 2), tx, ty,
                      frame_major=True)
        require_equal(f"H1 seed {seed} frame-major", fm,
                      path.transpose(1, 2))
        log(3, f"H1 seed {seed}: B={B_MAS} {T_X}x{T_Y} bit-identical to "
               f"mas_plain, items 2-5 to the numpy oracle; durations and "
               f"frame-major modes agree")
    value, t_x, t_y = ragged(2, 2, T_X, LONG_T_Y)
    v = torch.from_numpy(value).to(dev)
    tx = torch.from_numpy(t_x).to(dev)
    ty = torch.from_numpy(t_y).to(dev)
    require_equal("H1 long form", mas_path(v, tx, ty), mas_plain(v, tx, ty))
    log(3, f"H1 long form B=2 {T_X}x{LONG_T_Y} (t_y={t_y.tolist()}): "
           f"bit-identical to mas_plain")
    return max_err


def fs_inputs(seed, dev):
    from aligner_tpu_torch.ops.forward_sum import _masked_logp
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B_OTA, T_Y, T_X)).astype(np.float32) * 3
    t_x = rng.integers(T_X // 2, T_X + 1, B_OTA).astype(np.int32)
    t_y = np.maximum(t_x, rng.integers(T_Y // 4, T_Y + 1, B_OTA)) \
        .astype(np.int32)
    tx = torch.from_numpy(t_x).to(dev)
    ty = torch.from_numpy(t_y).to(dev)
    lp = torch.log_softmax(torch.from_numpy(logits).to(dev), dim=-1)
    return _masked_logp(lp, tx).transpose(0, 1), tx, ty


def phase_forward_sum(dev):
    from aligner_tpu_torch.ops.forward_sum import _total_from_alphas
    from aligner_tpu_torch.ops.forward_sum_kernel import (alpha_plain,
                                                          forward_sum_alpha)
    lp_tm, tx, ty = fs_inputs(3, dev)
    alphas, final = forward_sum_alpha(lp_tm, ty)
    want = alpha_plain(lp_tm, ty)
    got_total = _total_from_alphas(final, tx)
    want_total = _total_from_alphas(want[-1], tx)
    torch.cuda.synchronize()
    if not torch.allclose(got_total, want_total, rtol=FS_RTOL, atol=0):
        raise AssertionError(f"H2 final log-mass: {got_total} vs "
                             f"{want_total}")
    if not torch.equal(final, alphas[-1]):
        raise AssertionError("H2: final column is not the last alpha row")
    err = (got_total - want_total).abs().max().item()
    log(4, f"H2 B={B_OTA} {T_X}x{T_Y}: final log-mass within rtol "
           f"{FS_RTOL} of alpha_plain (max abs err {err:.3g} on totals "
           f"near {want_total.mean().item():.1f})")
    return err


def ota_inputs(dev):
    rng = np.random.default_rng(4)
    text_lengths = rng.integers(T_X // 2, T_X + 1, B_OTA).astype(np.int32)
    mel_lengths = np.maximum(
        text_lengths, rng.integers(T_Y // 4, T_Y + 1, B_OTA)).astype(np.int32)
    return (torch.from_numpy(rng.integers(0, VOCAB, (B_OTA, T_X))).to(dev),
            torch.from_numpy(rng.standard_normal((B_OTA, T_Y, N_MELS))
                             .astype(np.float32)).to(dev),
            torch.from_numpy(text_lengths).to(dev),
            torch.from_numpy(mel_lengths).to(dev))


def serving_requests():
    """Three requests of 40 ragged lattices up to 128x1024."""
    rng = np.random.default_rng(5)
    requests = []
    for _ in range(3):
        lats = []
        for _ in range(40):
            tx = int(rng.integers(1, T_X + 1))
            ty = int(rng.integers(tx, T_Y + 1))
            lats.append((rng.standard_normal((tx, ty)) * 3)
                        .astype(np.float32))
        requests.append(lats)
    return requests


def phase_main_path(dev):
    """Drive the entry points once; return their outputs and the kernel
    launches made there."""
    import aligner_tpu_torch as at
    from aligner_tpu_torch.utils.masks import lattice_mask
    value, t_x, t_y = ragged(6, B_MAS, T_X, T_Y)
    v = torch.from_numpy(value).to(dev)
    mask = lattice_mask(torch.from_numpy(t_x).to(dev),
                        torch.from_numpy(t_y).to(dev), T_X, T_Y)
    model = at.OTAAligner(
        at.OTAConfig(vocab_size=VOCAB, n_mels=N_MELS, dim=DIM,
                     hidden=HIDDEN, use_recon=True),
        device=dev, generator=torch.Generator().manual_seed(0))
    batch = ota_inputs(dev)
    requests = serving_requests()
    aligner = at.BatchAligner(max_text=T_X, max_mel=T_Y, max_batch=32,
                              device=dev)
    torch.cuda.synchronize()

    at.reset_kernel_launches()
    t0 = time.perf_counter()
    path = at.maximum_path(v, mask)
    with torch.no_grad():
        ota = model(*batch)
    served = [(aligner.align(r), aligner.align_durations(r))
              for r in requests]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = at.kernel_launches()
    log(5, f"maximum_path B={B_MAS}, OTA forward B={B_OTA} at "
           f"{VOCAB}/{N_MELS}/{DIM}/{HIDDEN} f32, BatchAligner 3x40 "
           f"requests (align + align_durations) in {seconds:.2f} s; "
           f"kernel launches {launches}")
    for name in ("mas_kernel", "forward_sum_alpha_kernel"):
        if launches.get(name, 0) < 1:
            raise AssertionError(f"the main path never launched {name}")
    return launches, (v, t_x, t_y, path), (batch, ota), (requests, served)


def phase_check_main(dev, mas_run, ota_run, serving_run):
    from aligner_tpu_torch.ops.forward_sum import (_masked_logp,
                                                   _total_from_alphas)
    from aligner_tpu_torch.ops.forward_sum_kernel import alpha_plain
    from aligner_tpu_torch.ops.mas_kernel import mas_plain

    v, t_x, t_y, path = mas_run
    require_equal("maximum_path vs mas_plain", path,
                  mas_plain(v, torch.from_numpy(t_x).to(dev),
                            torch.from_numpy(t_y).to(dev)))
    log(6, "maximum_path bit-identical to mas_plain")

    (tokens, mel, tl, ml), out = ota_run
    logp = out["logp_with_prior"]
    for key, val in out.items():
        if not torch.isfinite(val).all():
            raise AssertionError(f"OTA {key} is not finite")
    require_equal("OTA hard_path vs mas_plain", out["hard_path"],
                  mas_plain(logp.transpose(1, 2), tl, ml).transpose(1, 2))
    if not torch.equal(out["durations"].sum(-1), ml.float()):
        raise AssertionError("OTA durations do not sum to the mel lengths")
    alphas = alpha_plain(_masked_logp(logp, tl).transpose(0, 1), ml)
    total = _total_from_alphas(alphas[-1], tl)
    valid = (tl >= 1) & (tl <= ml)
    plain_loss = torch.mean(-torch.where(valid, total, 0.0)
                            / ml.clamp(min=1))
    got = out["loss_forward_sum"]
    if not torch.allclose(got, plain_loss, rtol=FS_RTOL, atol=0):
        raise AssertionError(f"OTA loss_forward_sum {got.item()} vs plain "
                             f"{plain_loss.item()}")
    log(6, f"OTA: hard_path bit-identical to mas_plain on its "
           f"logp_with_prior; loss_forward_sum {got.item():.6f} vs plain "
           f"{plain_loss.item():.6f}; durations sum to mel lengths; "
           f"loss_bin {out['loss_bin'].item():.4f}, loss_recon "
           f"{out['loss_recon'].item():.4f}")

    requests, served = serving_run
    for r, (lats, (aligned, durs)) in enumerate(zip(requests, served)):
        B = len(lats)
        value = np.zeros((B, T_X, T_Y), np.float32)
        tx = np.zeros(B, np.int32)
        ty = np.zeros(B, np.int32)
        for i, lat in enumerate(lats):
            tx[i], ty[i] = lat.shape
            value[i, :tx[i], :ty[i]] = lat
        want = mas_plain(torch.from_numpy(value).to(dev),
                         torch.from_numpy(tx).to(dev),
                         torch.from_numpy(ty).to(dev)).cpu().numpy()
        for i in range(B):
            w = want[i, :tx[i], :ty[i]]
            p, d = aligned[i]
            if not (np.array_equal(p, w) and np.array_equal(d, w.sum(-1))
                    and np.array_equal(durs[i], w.sum(-1))):
                raise AssertionError(f"BatchAligner request {r} item {i}")
    log(6, "BatchAligner: 3 requests x 40 lattices, align and "
           "align_durations equal to mas_plain")


def phase_times(dev):
    from aligner_tpu_torch.ops.forward_sum_kernel import (alpha_plain,
                                                          forward_sum_alpha,
                                                          forward_sum_grad,
                                                          gamma_plain)
    from aligner_tpu_torch.ops.mas_kernel import mas_path, mas_plain
    value, t_x, t_y = ragged(0, B_MAS, T_X, T_Y)
    v = torch.from_numpy(value).to(dev)
    tx = torch.from_numpy(t_x).to(dev)
    ty = torch.from_numpy(t_y).to(dev)
    lp_tm, ftx, fty = fs_inputs(3, dev)
    # Plain, kernel, kernel, plain: the order cancels drift in clocks.
    mas_plain_ms = cuda_ms(lambda: mas_plain(v, tx, ty), 2)
    mas_ms = cuda_ms(lambda: mas_path(v, tx, ty), 20)
    mas_ms = (mas_ms + cuda_ms(lambda: mas_path(v, tx, ty), 20)) / 2
    mas_plain_ms = (mas_plain_ms
                    + cuda_ms(lambda: mas_plain(v, tx, ty), 2)) / 2
    fs_plain_ms = cuda_ms(lambda: alpha_plain(lp_tm, fty), 2)
    fs_ms = cuda_ms(lambda: forward_sum_alpha(lp_tm, fty), 20)
    fs_ms = (fs_ms + cuda_ms(lambda: forward_sum_alpha(lp_tm, fty), 20)) / 2
    fs_plain_ms = (fs_plain_ms
                   + cuda_ms(lambda: alpha_plain(lp_tm, fty), 2)) / 2
    args = grad_inputs(dev)[:5]
    gr_plain_ms = cuda_ms(lambda: gamma_plain(*args), 2)
    gr_ms = cuda_ms(lambda: forward_sum_grad(*args), 20)
    gr_ms = (gr_ms + cuda_ms(lambda: forward_sum_grad(*args), 20)) / 2
    gr_plain_ms = (gr_plain_ms + cuda_ms(lambda: gamma_plain(*args), 2)) / 2
    log(7, f"H1 mas_path B={B_MAS} {T_X}x{T_Y} (zero-fill + kernel): "
           f"{mas_ms:.4f} ms; mas_plain {mas_plain_ms:.2f} ms")
    log(7, f"H2 forward_sum_alpha B={B_OTA} {T_X}x{T_Y}: {fs_ms:.4f} ms; "
           f"alpha_plain {fs_plain_ms:.2f} ms")
    log(7, f"H3 forward_sum_grad B={B_OTA} {T_X}x{T_Y}: {gr_ms:.4f} ms; "
           f"gamma_plain {gr_plain_ms:.2f} ms")
    return ((mas_ms, mas_plain_ms), (fs_ms, fs_plain_ms),
            (gr_ms, gr_plain_ms))


def grad_inputs(dev):
    """The beta sweep's inputs at B=16, 128x1024 ragged, with the edge
    items of tests/test_forward_sum_pallas.py: (lp_tm, alphas, total,
    t_x, t_y, log_probs). Items 0-5: t_y = 1; t_x > t_y; t_x = 0; a
    NEG-saturated diagonal band; a fully dead frame; -inf inputs."""
    from aligner_tpu_torch.ops.forward_sum import (_masked_logp,
                                                   _total_from_alphas,
                                                   _valid_items)
    from aligner_tpu_torch.ops.forward_sum_kernel import (NEG,
                                                          forward_sum_alpha)
    rng = np.random.default_rng(7)
    logits = torch.from_numpy(
        rng.standard_normal((B_OTA, T_Y, T_X)).astype(np.float32) * 3)
    lp = torch.log_softmax(logits, dim=-1).numpy()
    t_x = rng.integers(T_X // 2, T_X + 1, B_OTA).astype(np.int32)
    t_y = np.maximum(t_x, rng.integers(T_Y // 4, T_Y + 1, B_OTA)) \
        .astype(np.int32)
    t_x[0], t_y[0] = 1, 1
    t_x[1], t_y[1] = T_X, T_X // 2
    t_x[2] = 0
    center = np.arange(T_Y)[:, None] * t_x[3] // t_y[3]
    lp[3] = np.where(np.abs(np.arange(T_X)[None, :] - center) <= 2, lp[3],
                     NEG)
    lp[4, t_y[4] // 2, :] = NEG
    lp[5] = np.where(rng.random((T_Y, T_X)) < 0.1, -np.inf, lp[5])
    log_probs = torch.from_numpy(lp).to(dev)
    tx = torch.from_numpy(t_x).to(dev)
    ty = torch.from_numpy(t_y).to(dev)
    lp_tm = _masked_logp(log_probs, tx).transpose(0, 1)
    alphas, final = forward_sum_alpha(lp_tm, ty)
    total = torch.where(_valid_items(tx, ty), _total_from_alphas(final, tx),
                        0.0)
    return lp_tm, alphas, total, tx, ty, log_probs


def phase_grad(dev):
    """H3 against gamma_plain on the same inputs, and the loss gradient
    through autograd (kernel route) against the plain versions'."""
    from aligner_tpu_torch.ops.forward_sum_kernel import (NEG,
                                                          forward_sum_grad,
                                                          gamma_plain)
    lp_tm, alphas, total, tx, ty, log_probs = grad_inputs(dev)
    gamma = forward_sum_grad(lp_tm, alphas, total, tx, ty)
    want = gamma_plain(lp_tm, alphas, total, tx, ty)
    torch.cuda.synchronize()
    if not torch.isfinite(gamma).all():
        raise AssertionError("H3: gamma is not finite")
    torch.testing.assert_close(gamma, want, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    ys = torch.arange(T_Y, device=dev)[:, None, None]
    live = (ys < ty[None, :, None]) & (lp_tm > 0.5 * NEG)
    if gamma[~live].any():
        raise AssertionError("H3: gamma is not 0 off the live cells")
    err = (gamma - want).abs().max().item()
    torch.testing.assert_close(kernel_loss_grad(log_probs, tx, ty),
                               plain_loss_grad(log_probs, tx, ty),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    log(8, f"H3 B={B_OTA} {T_X}x{T_Y} with edge items (t_y=1, t_x>t_y, "
           f"t_x=0, NEG band, dead frame, -inf): within rtol {GRAD_RTOL} / "
           f"atol {GRAD_ATOL} of gamma_plain (max abs err {err:.3g}), 0 off "
           f"{int((~live).sum())} dead cells; forward_sum_loss backward "
           f"on the card equals the plain versions' gradient")
    return err


def kernel_loss_grad(log_probs, tx, ty):
    """d sum(forward_sum_loss) / d log_probs through autograd: kernels H2
    and H3 on a CUDA tensor."""
    from aligner_tpu_torch.ops.forward_sum import forward_sum_loss
    x = log_probs.clone().requires_grad_()
    forward_sum_loss(x, tx, ty).sum().backward()
    return x.grad


def plain_loss_grad(log_probs, tx, ty):
    """The same gradient from alpha_plain and gamma_plain on log_probs'
    device: -gamma, 0 for invalid items."""
    from aligner_tpu_torch.ops.forward_sum import (_masked_logp,
                                                   _total_from_alphas,
                                                   _valid_items)
    from aligner_tpu_torch.ops.forward_sum_kernel import (alpha_plain,
                                                          gamma_plain)
    lp_tm = _masked_logp(log_probs, tx).transpose(0, 1)
    alphas = alpha_plain(lp_tm, ty)
    valid = _valid_items(tx, ty)
    total = torch.where(valid, _total_from_alphas(alphas[-1], tx), 0.0)
    gamma = gamma_plain(lp_tm, alphas, total, tx, ty)
    return -gamma.transpose(0, 1) * valid[:, None, None]


def require_launches(where, launches, at_least):
    for name in ("mas_kernel", "forward_sum_alpha_kernel",
                 "forward_sum_grad_kernel"):
        if launches.get(name, 0) < at_least:
            raise AssertionError(f"{where}: {name} launched "
                                 f"{launches.get(name, 0)} times, expected "
                                 f">= {at_least}")


def train_batches():
    """Synthetic corpus at the CLI width, bucketed to B=16 with
    T_x <= 128 and T_mel <= 1024 (BASELINE.json config 3): full batches
    for training, one partial batch held out."""
    from aligner_tpu_torch.data import (SyntheticConfig, bucket_batches,
                                        make_corpus)
    cfg = SyntheticConfig(vocab_size=VOCAB, n_mels=N_MELS,
                          min_tokens=3 * T_X // 4 + 1, max_tokens=T_X,
                          min_duration=T_Y // T_X - 2,
                          max_duration=T_Y // T_X, seed=8)
    batches = list(bucket_batches(make_corpus(TRAIN_UTTERANCES, cfg), B_OTA,
                                  shuffle_seed=8))
    full = [b for b in batches if len(b["tokens"]) == B_OTA]
    held_out = [b for b in batches if len(b["tokens"]) < B_OTA][:1]
    return full, held_out or full[-1:]


def step_ms(step, state, batch, reps):
    """Median host-clock ms of `reps` synchronised steps after one
    warm-up step."""
    step(state, batch)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_train(dev):
    """Drive train_aligner at full width; return its launch counts and
    the step times."""
    import aligner_tpu_torch as at
    from aligner_tpu_torch.train import (create_train_state,
                                         make_train_step,
                                         restore_checkpoint)
    from aligner_tpu_torch.train.loop import train_aligner
    config = at.OTAConfig(vocab_size=VOCAB, n_mels=N_MELS, dim=DIM,
                          hidden=HIDDEN, use_recon=True)
    batches, held_out = train_batches()
    model = at.OTAAligner(config, device=dev)
    lines = []
    with tempfile.TemporaryDirectory() as ckpt:
        torch.cuda.synchronize()
        at.reset_kernel_launches()
        t0 = time.perf_counter()
        state, history = train_aligner(
            model, batches, steps=TRAIN_STEPS, device=dev, learning_rate=LR,
            bin_start=BIN_START, bin_ramp=BIN_RAMP, log_every=1,
            checkpoint_dir=ckpt, eval_batches=held_out,
            eval_every=TRAIN_STEPS,
            log_fn=lambda line: lines.append((time.perf_counter(), line)))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = at.kernel_launches()
        shapes = sorted({tuple(b["mel"].shape[:2]) for b in batches})
        log(9, f"train_aligner: {TRAIN_STEPS} steps at B={B_OTA}, "
               f"{VOCAB}/{N_MELS}/{DIM}/{HIDDEN} f32 + recon, "
               f"{len(batches)} batches of [B, T_mel] {shapes}, lr {LR}, "
               f"bin loss from step {BIN_START}, in {seconds:.2f} s; kernel "
               f"launches {launches}")
        require_launches("training path", launches, TRAIN_STEPS)
        train = [r for r in history if "loss" in r]
        val = [r for r in history if "val_loss" in r]
        for rec in history:
            if not all(np.isfinite(v) for v in rec.values()):
                raise AssertionError(f"a metric is not finite: {rec}")
        if len(train) != TRAIN_STEPS or len(val) != 1:
            raise AssertionError(f"{len(train)} train and {len(val)} val "
                                 f"records, expected {TRAIN_STEPS} and 1")
        if not train[-1]["loss"] < train[0]["loss"]:
            raise AssertionError(f"loss did not fall: {train[0]['loss']} "
                                 f"-> {train[-1]['loss']}")
        stamps = [t for t, line in lines if "val_loss" not in line]
        step_wall = statistics.median(
            (b - a) * 1e3 for a, b in zip(stamps[3:], stamps[4:]))
        log(9, f"loss {train[0]['loss']:.4f} -> {train[-1]['loss']:.4f} "
               f"(forward-sum {train[0]['loss_forward_sum']:.4f} -> "
               f"{train[-1]['loss_forward_sum']:.4f}); val_loss "
               f"{val[0]['val_loss']:.4f}; median wall {step_wall:.2f} ms "
               f"per step after 4 warm-up steps (log_every=1, a host read "
               f"per step)")

        fresh = at.OTAAligner(config, device=dev,
                              generator=torch.Generator().manual_seed(1))
        restored = restore_checkpoint(ckpt, create_train_state(
            fresh, learning_rate=LR))
        live = model.state_dict()
        for key, value in fresh.state_dict().items():
            if not torch.equal(value, live[key]):
                raise AssertionError(f"restored {key} differs")
        if restored.step != TRAIN_STEPS:
            raise AssertionError(f"restored step {restored.step}")
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batches[0].items()}
    at.reset_kernel_launches()
    _, metrics = make_train_step(fresh, bin_start=BIN_START,
                                 bin_ramp=BIN_RAMP)(restored, batch)
    if not np.isfinite(float(metrics["loss"])):
        raise AssertionError(f"the resumed step failed: {metrics}")
    require_launches("resumed step", at.kernel_launches(), 1)
    log(9, f"checkpoint restored at step {TRAIN_STEPS}, parameters equal "
           f"to the live ones; resumed step {restored.step}: loss "
           f"{float(metrics['loss']):.4f}")

    card_err, cpu_err, lattice_diff, rel = grad_vs_cpu(model, config, batch)
    log(9, f"the trained model's lattice {tuple(batch['mel'].shape[:2])}: "
           f"forward-sum gradient by the kernels within rtol {GRAD_RTOL} / "
           f"atol {GRAD_ATOL} of the plain versions on the card (max abs "
           f"err {card_err:.3g}), {cpu_err:.3g} from the plain versions on "
           f"a CPU copy; card and CPU models: lattices differ by at most "
           f"{lattice_diff:.3g} on live cells, loss_forward_sum parameter "
           f"gradients by a max relative {rel:.3g} (max |diff| / max |grad| "
           f"per tensor)")
    if not rel < GRAD_REL_LIMIT:
        raise AssertionError(f"card and CPU gradients differ by {rel}")

    step16 = step_ms(make_train_step(fresh, bin_start=0, bin_ramp=1),
                     restored, batch, 10)
    long_model = at.OTAAligner(config, device=dev)
    long_state = create_train_state(long_model, learning_rate=LR)
    rng = np.random.default_rng(9)
    text_lengths = rng.integers(T_X // 2, T_X + 1, B_LONG)
    long_batch = {
        "tokens": torch.from_numpy(rng.integers(1, VOCAB, (B_LONG, T_X))),
        "mel": torch.from_numpy(rng.standard_normal(
            (B_LONG, T_Y_LONG, N_MELS)).astype(np.float32)),
        "text_lengths": torch.from_numpy(text_lengths),
        "mel_lengths": torch.from_numpy(np.maximum(text_lengths, rng.integers(
            T_Y_LONG // 2, T_Y_LONG + 1, B_LONG)))}
    long_batch["mel_lengths"][0] = T_Y_LONG
    long_batch = {k: v.to(dev) for k, v in long_batch.items()}
    at.reset_kernel_launches()
    step64 = step_ms(make_train_step(long_model, bin_start=0, bin_ramp=1),
                     long_state, long_batch, 3)
    require_launches("config-5 step", at.kernel_launches(), 4)
    log(9, f"step time (host clock, synchronised, median): B={B_OTA} "
           f"T_mel<={T_Y} {step16:.2f} ms over 10 steps; B={B_LONG} "
           f"T_mel={T_Y_LONG} {step64:.2f} ms over 3 steps; "
           f"peak device memory "
           f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    return launches, step_wall, step16, step64


def grad_vs_cpu(model, config, batch):
    """One batch through the trained model on the card and through a CPU
    copy of it (plain versions). On the card's own lattice, the max abs
    difference of the forward-sum gradient by the kernels from the plain
    versions on the card (held to GRAD_RTOL/GRAD_ATOL) and on a CPU copy
    of the lattice (the CPU's exp and log1p, reported); the max card-CPU
    lattice difference on live cells; and the max over tensors of
    max|g_card - g_cpu| / max|g_cpu| of the loss_forward_sum parameter
    gradients (bin weight 0)."""
    import aligner_tpu_torch as at
    lengths = ("text_lengths", "mel_lengths")
    cpu_model = at.OTAAligner(config, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    grads, lattices = [], []
    for m, dev in ((model, batch["tokens"].device),
                   (cpu_model, torch.device("cpu"))):
        m.zero_grad(set_to_none=True)
        out = m(*[batch[k].to(dev) for k in ("tokens", "mel", *lengths)])
        out["loss_forward_sum"].backward()
        grads.append({k: p.grad.cpu() for k, p in m.named_parameters()
                      if p.grad is not None})
        lattices.append(out["logp_with_prior"].detach())
    card, cpu = grads
    if card.keys() != cpu.keys() or not card:
        raise AssertionError("card and CPU gradients cover other tensors")
    rel = max(((card[k] - cpu[k]).abs().max()
               / cpu[k].abs().max().clamp(min=1e-30)).item() for k in cpu)
    live = lattices[1] > -1e10
    lattice_diff = (lattices[0].cpu() - lattices[1])[live].abs().max().item()

    lp = lattices[0]
    tx, ty = (batch[k].to(lp.device) for k in lengths)
    got = kernel_loss_grad(lp, tx, ty)
    want = plain_loss_grad(lp, tx, ty)
    torch.testing.assert_close(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    card_err = (got - want).abs().max().item()
    cpu_err = (got.cpu() - plain_loss_grad(lp.cpu(), tx.cpu(), ty.cpu())) \
        .abs().max().item()
    return card_err, cpu_err, lattice_diff, rel


def phase_demo(dev):
    cmd = [sys.executable, "-m", "aligner_tpu_torch", "demo-ota",
           "--steps", str(DEMO_STEPS), "--device", dev.type]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(cmd[1:])} exited "
                             f"{proc.returncode}:\n{proc.stdout}"
                             f"{proc.stderr}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    if rec.get("demo") != "ota" or not {"duration_exact", "duration_mae",
                                        "boundary_f1_tol2"} <= set(rec):
        raise AssertionError(f"demo-ota printed {rec}")
    log(10, f"demo-ota --steps {DEMO_STEPS} --device {dev.type} in "
            f"{time.perf_counter() - t0:.1f} s: {json.dumps(rec)}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing runs on the CPU instead",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    phase_device()
    phase_build()
    mas_err = phase_mas(dev)
    fs_err = phase_forward_sum(dev)
    # Exact float32 matmuls and convolutions for the comparisons below.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(5, "TF32 off for matmul and cuDNN (float32 throughout)")
    serving, mas_run, ota_run, serving_run = phase_main_path(dev)
    phase_check_main(dev, mas_run, ota_run, serving_run)
    times = phase_times(dev)
    grad_err = phase_grad(dev)
    training, *_ = phase_train(dev)
    phase_demo(dev)
    kernels = []
    for (name, source, replaces, err), (ms, plain_ms) in zip([
            ("mas_kernel", "mas.cu", "mas_pallas.py:547", mas_err),
            ("forward_sum_alpha_kernel", "forward_sum.cu",
             "forward_sum_pallas.py:77", fs_err),
            ("forward_sum_grad_kernel", "forward_sum.cu",
             "forward_sum_pallas.py:126", grad_err)], times):
        by_path = {"serving": serving.get(name, 0),
                   "training": training.get(name, 0)}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"aligner_tpu_torch/csrc/{source}",
            "replaces": f"aligner_tpu/ops/{replaces}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
