"""Smoke run of aligner_tpu_torch on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Builds the package's CUDA kernels from `aligner_tpu_torch/csrc/` with nvcc
(sm_90a), holds each against its plain PyTorch version on the card, then
drives the five main paths through the public entry points and checks
that every kernel of each path was launched there: serving
(`maximum_path`, `OTAAligner` at the CLI's default width, `BatchAligner`),
training (`train_aligner` at the same width, checkpoints, `demo-ota`), the
pause-aware path (`SkipBatchAligner`, `OTAAligner(model_pauses=True)`,
`train_aligner` with a `pause_bias` curriculum, `demo-pauses`) and the
boundary-search path (`MoBoAligner`, `RoMoAligner`, `train_aligner` with
their reconstruction objectives, `demo-mobo`, `demo-romo`), the two-pass
MAS route at the serving batch (`mas_path(fuse=False)` in every form,
`bench-mas`) and the wav pipeline (`train` then `align` through the CLI on
corpora from scripts/make_wav_corpus.py). Phases, in number order (18 runs
after 4):

  1. the card (nvidia-smi name and power limit)
  2. kernel build
  3. H1 (MAS) against mas_plain and the numpy oracle, bit-identical, with
     its bit plane in shared memory (as planned) and forced into device
     memory, natural (tiles) and frame-major (rows), durations mode and
     the long form 128x8192, every output pre-filled with garbage
  4. H2 (forward-sum alpha) against alpha_plain, rtol 1e-5, over the
     whole lattice (frozen frames included) written over NaN, with edge
     items, a strided column and T_x = 1100
  5. serving path: maximum_path, OTA forward, BatchAligner; launch counts
  6. the serving path's results against the plain route
  7. CUDA-event times of each kernel against its plain version, beside
     the least time the card could take for the same bytes, operations
     and special-function results (H7's and H9's cluster plan beside them);
     for H1-H6 and H13 also the time per frame of the longest item, for
     H7-H9 per token; H7-H9 again at
     B=64, B=256 and D=1; H1 again
     frame-major, with its plane forced into device memory and at the
     profiled training step's lattice, H5 at T_s = 1041, and the serving
     walls of maximum_path and BatchAligner; H3 again at
     config 5's shape and at the profiled training step's, H4 with its
     move planes forced into device memory and at the profiled pause
     step's lattice in both layouts; for H12 also the one library call
     that computes its function (`torch.eq` into a float32 output), which
     the package never calls, by CUDA events and by the profiler's device
     time of the kernel alone, at B=32 and B=256; H10, H11, H14 and H1's
     walk alone by the profiler's device time too, H11 beside its chain
     (its longest item's frames at H10's step at B=32)
  8. H3 (forward-sum beta/posterior) against gamma_plain, rtol 1e-5 /
     atol 1e-6, into an output pre-filled with NaN, and the loss gradient
     on the card against the plain one
  9. training path: train_aligner at B=16 on a synthetic corpus, launch
     counts, checkpoint restore and a resumed step, parameter gradients
     against a CPU copy, step times at B=16 and at B=64 x 2048 frames,
     torch.profiler breakdowns of both steps, the latter's peak memory
 10. `python -m aligner_tpu_torch demo-ota --device cuda` as a subprocess
 11. H4 (skip-state Viterbi) against mas_skip_plain and the numpy oracle,
     bit-identical, with edge items, two enter costs and T_s > 1024, its
     move planes in shared memory and in device memory, both layouts
 12. H5 (skip forward-sum alpha) against alpha_skip_plain and H6 (skip
     beta/posterior) against gamma_skip_plain, rtol 1e-5 / atol 1e-6, with
     each of the three enter costs, both into outputs pre-filled with NaN
     (H5 also at T_s = 1041), and the skip loss's backward against the
     plain route's
 13. pause-aware path with every plain version patched to raise:
     SkipBatchAligner on three requests, the pause OTA forward, and
     train_aligner on a silence-bearing corpus with the pause_bias
     curriculum and a checkpoint round trip; launch counts on each; the
     pause step's time beside the pause-blind step's, and its profile
 14. `python -m aligner_tpu_torch demo-pauses --skip-blind --device cuda`
 15. H7 (MoBo alpha), H8 (MoBo backpointers and walk) and H9 (MoBo beta)
     against mobo_alpha_plain, mobo_bp_plain and mobo_beta_plain with edge
     items at B = 16, D = 32 and T_y1 = 1025, at D = 4 with another T_y1,
     at T_y1 = 131 (slices barely wider than D = 32), and at B = 64 x 1025
     (a smaller cluster): live cells rtol 1e-6 / atol 1e-5, each plan
     (C, w) and max abs error printed, dead cells below NEG / 2; H8 over
     outputs pre-filled with garbage: backpointers and durations equal,
     durations of feasible items tiling
     t_y in steps of 1..D; the backward of mobo_forward and
     of mobo_loss on the card against the plain route's, rtol 1e-4 / atol
     2e-5
 16. boundary-search path with every plain version patched to raise: the
     MoBoAligner and RoMoAligner forward with hard boundaries (held
     against the same models on the plain route), train_aligner for each
     with its reconstruction objective and a checkpoint round trip; launch
     counts on each; step times, both steps' profiles and the share of
     the plain-PyTorch adjoint
 17. `python -m aligner_tpu_torch demo-mobo --device cuda` and `demo-romo`
 18. the two-pass kernels against their plain versions at B=32 and at the
     serving batch B=256, 128x1024, and at an odd shape (T_x no multiple of
     32, T_y no multiple of 128), with edge items: `mas_bits` with 1, 2
     and 4 chains (H1's forward alone, H13) equal to `_forward_bits` and
     to each other on every cell, from both layouts, over garbage (H1's
     in both plane forms; its walk alone in both plane forms);
     `mas_backtrack` as cmp (H1's walk alone), stage (H10), split (H11 +
     H12) and with 2 and 4 chains (H14) equal to `_backtrack`, `mas_plain`,
     the fused H1 and the numpy oracle, bit for bit, in both layouts; H11's
     indices equal to `mas_walk_idx_plain` on every frame, written over
     rows of 0x7F7F7F7F; H10, H12 and H14 write into an output pre-filled
     with NaN, so an unwritten cell shows; every walk on bits from
     elsewhere (bytes above 1, ones in row 0) stays inside the lattice and
     gives the same path; H10, H11 and H14 (the ring walk, each plan
     logged) also from bits 4 and 1 bytes off a 16-byte boundary (its
     4-byte and byte fetches), and on the long form B=4 x 128x8192 from
     each fetch
 19. two-pass path with every plain version patched to raise: every route
     of `mas_path(fuse=False)` at B=256, 128x1024, launch counts per
     route, each path equal to the fused kernel's; then
     `python -m aligner_tpu_torch bench-mas --route all --device cuda` at
     B=32 and B=256 as subprocesses, one gated JSON line per route
 20. wav pipeline with every plain version patched to raise: two seeded
     64-utterance corpora from scripts/make_wav_corpus.py (characters; phone
     transcripts with pauses), the card's log-mel of four utterances
     against the CPU's at atol 1e-4, then `train` and `align` (with
     TextGrids) through the CLI at its default width for OTA (`--recon
     --temperature 0.15`), OTA `--model-pauses` and RoMo (both `--tokenizer
     phone`): launch counts of each run (H1-H3; H4-H6; H2, H3, H7-H9), one
     record and one TextGrid per utterance, frames conserved (RoMo's rough
     fallback within a frame a token), the config.json keys, the corpus
     load time and the wall a step; `python -m aligner_tpu_torch align
     --device cuda` as a subprocess writing the same records; each
     output's scores (`score_wav`), printed and not gated; a fourth run
     trains OTA `--recon --temperature 0.15 --compute-dtype bfloat16`
     (H1-H3) with `compute_dtype` in its config.json
 21. bfloat16 compute with every plain version refused: train_aligner at
     the CLI width for 10 steps pause-blind (phase 9's batches) and
     pause-aware (phase 13's, with the pause_bias curriculum): the loss
     falls, the parameters stay float32, the lattice is float32 and the
     hard path takes one state a live frame; launch counts (H1-H3; H4-H6);
     step times and profiles beside phases 9 and 13's float32 steps;
     config 5 (B=64 x 2048, 3 steps) with its profile and peak memory,
     beside phase 9's float32 step; the card's bf16 encoders and log_attn
     against a CPU copy's at the tolerances of tests/test_torch_bf16.py
 22. maximum_path(implementation="cpp") on CUDA tensors equal to H1 at
     B=32 128x1024 and B=1 64x256, with launch counts (auto: one H1;
     cpp: none), and both routes' walls at B=1 (median of 50)
 23. examples/batch_serving_torch.py and
     examples/vits_style_integration_torch.py with --device cuda, then
     the conformance sweeps (`aligner_tpu_torch.conformance` and
     `conformance_losses`, one seed) with every plain version refused to
     the wrappers: every case bit-identical or within tolerance, every
     plan reached (the MoBo grid: H7-H9 in clusters of 8, 2 and 1 blocks,
     H8's wide form, D = 1), the count of cases logged
 24. the parallel path at world size 1 with every plain version refused:
     a 1x1 ("data", "model") mesh over NCCL from a file store; 4 sharded
     train steps (`create_train_state(mesh=)`, `make_train_step(mesh=)`:
     DistributedDataParallel) at the CLI width of OTA with its
     reconstruction (phase 9's batches), the pause-aware OTA with the
     pause_bias curriculum and the silence anchor (phase 13's) and MoBo
     (D = 32), each against the unsharded step from the same init (losses
     within rtol 2e-4 / atol 1e-5, the largest parameter difference
     printed; launches H1-H3, H4-H6, H7 and H9); `train_aligner(mesh=)`
     for 20 steps with a checkpoint restored into an unsharded model,
     whose next step equals the sharded run's; `mas_sequence_parallel`
     gated and with 2 microbatches at B=32, 128x1024, bit-identical to H1;
     the graft twin's forward (`graft_entry.entry`, H1 and H2) against the
     CPU's plain route; the walls of a sharded and an unsharded step
     (in the order sharded, unsharded, unsharded, sharded), then both
     under the profiler: device busy time and the device and host
     operations the sharded step adds
 25. the quality campaigns and a pause diagnostic at a smoke size (30
     steps, 16-utterance corpora): `wav_rows` on round5's hop128_s0 (and
     its resume, which trains nothing) and on wav_pauses' seed-0
     pause-aware row, every plain version refused, each line with its
     scores and its JAX row; `demo_rows` on one row as a subprocess;
     `pause_swap_probe --hard` with its lever grid and swap count;
     launches H1-H3 and H4-H6; then the weight-decay repair: a
     forward-sum-only step at the CLI width leaves the reconstruction
     decoder, which takes no gradient, at before * (1 - lr * wd) with
     zero Adam moments

The second-to-last line is a JSON object listing the kernels (launches by
path: serving, training, pauses, mobo, two_pass, wav, bf16, parallel,
campaigns); the
last is {"ok": true, "device": {...}}. Any failed check raises, and the
script exits non-zero without a result; so it does without a CUDA device,
or without the package beside it. Nothing runs on the CPU in its place; the
CPU runs are references: phase 9's gradient and phase 24's graft forward.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from aligner_tpu_torch.utils.profiling import (device_time_by_kernel,
                                               measure_device_time)

B_MAS, T_X, T_Y = 32, 128, 1024          # headline MAS shape (bench.py)
B_SERVE = 256                            # serving batch of the two-pass route
ODD_SHAPE = (8, 45, 300)                 # B, T_x (% 32 != 0), T_y (% 128 != 0)
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
MEL_ATOL = 1e-4                          # card (cuFFT) vs CPU log-mel
DEMO_STEPS = 30
PAUSE_UTTERANCES = 160
ENTER_COSTS = (0.0, -1.2, 0.6)
T_X_WIDE = 520                           # 2*520+1 = 1041 states > 1024 threads
D_MOBO, WINDOW_ROMO = 32, 16              # BASELINE.json config 4
MOBO_RTOL, MOBO_ATOL = 1e-6, 1e-5        # live cells, kernel vs plain
MOBO_GRAD_RTOL, MOBO_GRAD_ATOL = 1e-4, 2e-5
# Published peaks of the H100 SXM: HBM3 bytes/s, and float32 operations/s
# outside the tensor cores (these sweeps have no matrix product).
PEAK_BYTES_PER_S, PEAK_F32_OPS_PER_S = 3.35e12, 67e12
# Special-function results (expf, logf, log1pf) per clock per SM at compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput), times the card's SMs and its maximum SM clock.
SFU_PER_CLOCK_PER_SM, SMS = 16, 132
MOBO_SHAPES = ((15, B_OTA, T_Y, D_MOBO), (16, B_OTA, 300, 4),
               (17, B_OTA, 130, D_MOBO), (18, 64, T_Y, D_MOBO))


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
    from aligner_tpu_torch._build import card_label
    card = card_label(0)
    print(card, flush=True)
    log(1, f"torch {torch.__version__} cuda {torch.version.cuda}; "
           f"device 0: {torch.cuda.get_device_name(0)}; "
           f"count {torch.cuda.device_count()}; maximum SM clock "
           f"{max_sm_clock_hz() / 1e6:.0f} MHz")
    return card


@functools.lru_cache(maxsize=None)
def max_sm_clock_hz():
    """Card 0's maximum SM clock, as `nvidia-smi --query-gpu=clocks.max.sm`
    gives it, in Hz."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(smi.stdout.split()[0]) * 1e6


def phase_build():
    from aligner_tpu_torch import _build
    t0 = time.perf_counter()
    _build.load_library()
    log(2, f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
           f"(nvcc {_build.BUILD_INFO['seconds']:.1f} s)")
    for line in _build.BUILD_INFO["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(2, "ptxas: " + line.strip())


PLANES = ("shared", "global")   # where H1's bit plane lives


@contextlib.contextmanager
def mas_planes_in(where):
    """While active, H1 keeps its bit plane where `where` says: "shared"
    is its plan as chosen; "global" forces it into device memory whatever
    the shape, with its plan's threads, cells and fetch and the ring of
    the device-memory plan for them."""
    from aligner_tpu_torch.ops import mas_kernel as mk
    plan = mk._mas_plan

    def device_memory_plan(T_x, T_y, frames_contiguous):
        threads, cells, ring, planes, fetch, smem = plan(T_x, T_y,
                                                         frames_contiguous)
        if fetch == "wide":
            return threads, cells, ring, planes, fetch, smem
        ring = next(r for c, r, p, f in mk.MAS_PLANS
                    if (c, p, f) == (cells, "global", fetch))
        return (threads, cells, ring, "global", fetch,
                mk._mas_smem(threads * cells, ring, 0))

    patches = [] if where == "shared" else [(mk, "_mas_plan",
                                             device_memory_plan)]
    with patched_attrs(patches):
        yield


@contextlib.contextmanager
def mas_outputs_prefilled():
    """While active, every output that H1 or H13 writes whole starts as
    garbage (paths NaN, durations -1, bytes 0xA5), so a cell it leaves
    unwritten shows."""
    from aligner_tpu_torch.ops import mas_kernel as mk
    path_out, bits_out = mk._path_out, mk._bits_out
    durations_out = mk._durations_out

    def paths(*args):
        out, view = path_out(*args)
        out.fill_(float("nan"))
        return out, view

    def bits(*args):
        return bits_out(*args).fill_(0xA5)

    with patched_attrs([(mk, "_path_out", paths), (mk, "_bits_out", bits),
                        (mk, "_durations_out",
                         lambda *args: durations_out(*args).fill_(-1))]):
        yield


def phase_mas(dev):
    """H1 against mas_plain and the numpy oracle, in each plane form and
    fetch (natural lattice: tiles; frame-major view: rows), every output
    pre-filled with garbage; returns the max abs error (0 or the phase
    fails)."""
    from aligner_tpu_torch.ops import mas_kernel as mk
    from aligner_tpu_torch.ops.mas_reference import mas_single
    max_err = 0.0
    inputs = []
    for seed in (0, 1):
        value, t_x, t_y = ragged(seed, B_MAS, T_X, T_Y)
        if seed == 1:           # contract edges: t_x > t_y, and t_x = 0
            t_x[0], t_y[0] = T_X, T_X // 2
            t_x[1], t_y[1] = 0, T_Y // 2
        inputs.append((seed, value, t_x, t_y))
    long_form = ragged(2, 2, T_X, LONG_T_Y)
    with mas_outputs_prefilled():
        for where in PLANES:
            with mas_planes_in(where):
                for seed, value, t_x, t_y in inputs:
                    v, tx, ty = (torch.from_numpy(a).to(dev)
                                 for a in (value, t_x, t_y))
                    fm_view = v.transpose(1, 2).contiguous().transpose(1, 2)
                    plans = [mk._mas_plan(T_X, T_Y, c)[:5]
                             for c in (True, False)]
                    path = mk.mas_path(v, tx, ty)
                    want = mk.mas_plain(v, tx, ty)
                    torch.cuda.synchronize()
                    where_ = f"H1 planes {where} seed {seed}"
                    require_equal(f"{where_} vs mas_plain", path, want)
                    max_err = max(max_err, (path - want).abs().max().item())
                    if seed == 1 and path[:2].any():
                        raise AssertionError("H1: invalid items must get "
                                             "zero paths")
                    for i in range(2, 6):
                        oracle = mas_single(value[i].copy(), int(t_x[i]),
                                            int(t_y[i]))
                        if not np.array_equal(
                                path[i].cpu().numpy().astype(np.int32),
                                oracle):
                            raise AssertionError(f"{where_} item {i} vs "
                                                 f"oracle")
                    require_equal(f"{where_} durations mode",
                                  mk.mas_durations(v, tx, ty),
                                  want.sum(-1).to(torch.int32))
                    fm = mk.mas_path(fm_view, tx, ty, frame_major=True)
                    require_equal(f"{where_} frame-major", fm,
                                  want.transpose(1, 2))
                    log(3, f"{where_}: B={B_MAS} {T_X}x{T_Y} bit-identical "
                           f"to mas_plain, items 2-5 to the numpy oracle; "
                           f"durations and frame-major modes agree; every "
                           f"output written over garbage; plans (threads, "
                           f"cells, ring, planes, fetch) natural {plans[0]}, "
                           f"frame-major {plans[1]}")
                value, t_x, t_y = long_form
                v, tx, ty = (torch.from_numpy(a).to(dev)
                             for a in (value, t_x, t_y))
                want = mk.mas_plain(v, tx, ty)
                require_equal(f"H1 planes {where} long form",
                              mk.mas_path(v, tx, ty), want)
                require_equal(
                    f"H1 planes {where} long form, frame-major",
                    mk.mas_path(v.transpose(1, 2).contiguous()
                                .transpose(1, 2), tx, ty, frame_major=True),
                    want.transpose(1, 2))
                log(3, f"H1 planes {where} long form B=2 {T_X}x{LONG_T_Y} "
                       f"(t_y={t_y.tolist()}), natural and frame-major: "
                       f"bit-identical to mas_plain; plan "
                       f"{mk._mas_plan(T_X, LONG_T_Y, True)[:5]}")
    return max_err


TWO_PASS_KERNELS = ("mas_walk_stage_kernel", "mas_walk_idx_kernel",
                    "mas_expand_kernel", "mas_bits_chains_kernel",
                    "mas_walk_chains_kernel")
# (form, chains) of mas_backtrack -> the kernel that walks
WALKS = {("cmp", 1): "mas_kernel", ("stage", 1): "mas_walk_stage_kernel",
         ("split", 1): "mas_expand_kernel",
         ("cmp", 2): "mas_walk_chains_kernel",
         ("cmp", 4): "mas_walk_chains_kernel"}


RING_WALKS = ("mas_walk_stage_kernel", "mas_walk_chains_kernel")


def two_pass_inputs(seed, B, T_x, T_y, dev):
    """A ragged batch with edge items 0-4: t_x = 1; t_x = t_y; t_x > t_y;
    t_x = 0; a full-length item."""
    value, t_x, t_y = ragged(seed, B, T_x, T_y)
    t_x[:5] = [1, T_x, T_x, 0, T_x]
    t_y[:5] = [T_y // 2, T_x, T_x // 2, T_y // 2, T_y]
    return (value, t_x, t_y,
            *(torch.from_numpy(a).to(dev) for a in (value, t_x, t_y)))


@contextlib.contextmanager
def two_pass_outputs_prefilled():
    """While active, every output that a two-pass kernel writes whole
    (allocated uninitialised) starts as garbage: paths NaN, H11's index
    rows 0x7F7F7F7F."""
    from aligner_tpu_torch.ops import mas_kernel as mk
    path_out = mk._path_out
    idx_out = mk._idx_out

    def prefilled(*args):
        out, view = path_out(*args)
        out.fill_(float("nan"))
        return out, view

    with patched_attrs([(mk, "_path_out", prefilled),
                        (mk, "_idx_out",
                         lambda *args: idx_out(*args).fill_(0x7F7F7F7F))]):
        yield


def idx_walk_checks(mk, bits, tx, ty, where):
    """H11 against `mas_walk_idx_plain` on every frame, into rows
    pre-filled with garbage (inside `two_pass_outputs_prefilled`), from
    bits 0, 4 and 1 bytes off a 16-byte boundary (its bulk, 4-byte and
    byte fetches where the shape allows them) and from bits from elsewhere
    (bytes of 3, ones at token 0). Returns (max abs error, unequal cells,
    the fetches taken)."""
    foreign = bits * 3
    foreign[:, :, 0] = 1
    B, T_y, T_x = bits.shape
    err, unequal, fetches = 0.0, 0, []
    for given in (bits, foreign):
        want = mk.mas_walk_idx_plain(given, tx, ty)
        for offset in (0, 4, 1):
            moved = shifted(given, offset)
            fetches.append(mk._walk_plan(T_x, T_y, 1, moved.data_ptr(),
                                         threads=mk.IDX_WALK_THREADS)[3])
            got = mk.mas_walk_idx(moved, tx, ty)
            torch.cuda.synchronize()
            unequal += int((got != want).sum())
            err = max(err, float((got - want).abs().max()))
            require_equal(f"H11 indices, {where}, bits at offset {offset}",
                          got, want)
    return err, unequal, fetches


@contextlib.contextmanager
def gamma_prefilled_with_nan():
    """While active, the posterior sweeps H3 and H6 write into an output
    pre-filled with NaN (allocated uninitialised otherwise), so a cell
    they leave unwritten shows."""
    from aligner_tpu_torch.ops import forward_sum_kernel as fs
    from aligner_tpu_torch.ops import skip_dp_kernel as sk
    gamma_out = fs._gamma_out

    def prefilled(*args):
        return gamma_out(*args).fill_(float("nan"))

    with patched_attrs([(fs, "_gamma_out", prefilled),
                        (sk, "_gamma_out", prefilled)]):
        yield


def phase_two_pass_kernels(dev):
    """H10-H14 and H1's two halves against their plain versions on the
    card; returns each new kernel's max abs difference (0 or the phase
    fails)."""
    from aligner_tpu_torch.ops import mas_kernel as mk
    from aligner_tpu_torch.ops.mas_reference import MAX_NEG_VAL, mas_single
    errs = dict.fromkeys(TWO_PASS_KERNELS, 0.0)
    for seed, (B, T_x, T_y) in ((18, (B_MAS, T_X, T_Y)), (19, ODD_SHAPE),
                                (21, (B_SERVE, T_X, T_Y))):
        value, t_x, t_y, v, tx, ty = two_pass_inputs(seed, B, T_x, T_y, dev)
        plain_tm = mk._forward_bits(v, tx, ty, MAX_NEG_VAL)
        want_bits = plain_tm.permute(1, 0, 2).to(torch.uint8)
        want_bits = want_bits * mk._valid_items(tx, ty, T_x, T_y)[:, None,
                                                                  None]
        want = mk.mas_plain(v, tx, ty)
        # H1's two halves in each plane form, every output written over
        # garbage, the forward from either layout.
        with mas_outputs_prefilled():
            for where in PLANES:
                with mas_planes_in(where):
                    for lattice in (v, v.transpose(1, 2).contiguous()
                                    .transpose(1, 2)):
                        bits = mk.mas_bits(lattice, tx, ty)
                        torch.cuda.synchronize()
                        require_equal(f"H1 bits alone, planes {where}, "
                                      f"{T_x}x{T_y}", bits, want_bits)
                    for fm in (False, True):
                        got = mk.mas_backtrack(bits, tx, ty, frame_major=fm)
                        require_equal(f"H1 walk alone, planes {where}, "
                                      f"frame_major={fm}, {T_x}x{T_y}", got,
                                      want.transpose(1, 2) if fm else want)
        if bits[2:4].any():
            raise AssertionError("mas_bits: invalid items must get zeros")
        # H13 over garbage, natural (tiles) and frame-major (rows).
        with mas_outputs_prefilled():
            for k in (2, 4):
                for lattice in (v, v.transpose(1, 2).contiguous()
                                .transpose(1, 2)):
                    plan = mk._chains_plan(T_x, T_y, k,
                                           lattice.stride(2) == 1)
                    got = mk.mas_bits(lattice, tx, ty, chains=k)
                    torch.cuda.synchronize()
                    require_equal(f"H13 chains={k}, {T_x}x{T_y}, plan "
                                  f"{plan}", got, want_bits)
                    errs["mas_bits_chains_kernel"] = max(
                        errs["mas_bits_chains_kernel"],
                        float((got != want_bits).sum()))
        require_equal("_backtrack of the plain bits vs mas_plain",
                      mk._backtrack(plain_tm, tx, ty), want)
        require_equal("H1 fused vs mas_plain", mk.mas_path(v, tx, ty), want)
        if want[2:4].any():
            raise AssertionError("invalid items must get zero paths")
        for i in (0, 1, 4, 5, 6):
            oracle = mas_single(value[i].copy(), int(t_x[i]), int(t_y[i]))
            if not np.array_equal(want[i].cpu().numpy().astype(np.int32),
                                  oracle):
                raise AssertionError(f"mas_plain item {i} vs oracle")
        with two_pass_outputs_prefilled():
            err, unequal, idx_fetches = idx_walk_checks(
                mk, bits, tx, ty, f"B={B} {T_x}x{T_y}")
            errs["mas_walk_idx_kernel"] = max(errs["mas_walk_idx_kernel"],
                                              err)
            for (form, k), kernel in WALKS.items():
                got = mk.mas_backtrack(bits, tx, ty, form=form, chains=k)
                fm = mk.mas_backtrack(bits, tx, ty, form=form, chains=k,
                                      frame_major=True)
                torch.cuda.synchronize()
                where = f"mas_backtrack form={form} chains={k}, {T_x}x{T_y}"
                require_equal(where, got, want)
                require_equal(where + " frame-major", fm,
                              want.transpose(1, 2))
                if kernel in errs:
                    errs[kernel] = max(errs[kernel],
                                       (got - want).abs().max().item())
            # Bits from elsewhere: any non-zero byte is a set bit, and a
            # set bit in row 0 must not take the walk below the lattice.
            foreign = bits * 3
            foreign[:, :, 0] = 1
            for form, k in WALKS:
                require_equal(f"mas_backtrack form={form} chains={k} on "
                              f"foreign bits, {T_x}x{T_y}",
                              mk.mas_backtrack(foreign, tx, ty, form=form,
                                               chains=k), want)
            plans = [walk_plans(mk, bits)]
            # The ring walk's other fetches: bits 4 and 1 bytes past a
            # 16-byte boundary (4-byte cp.async where T_x % 4 == 0, else
            # byte loads).
            for offset in (4, 1):
                moved = shifted(bits, offset)
                plans.append(walk_plans(mk, moved))
                for (form, k), kernel in WALKS.items():
                    if kernel not in RING_WALKS:
                        continue
                    for fm in (False, True):
                        got = mk.mas_backtrack(moved, tx, ty, form=form,
                                               chains=k, frame_major=fm)
                        require_equal(f"mas_backtrack form={form} chains={k}"
                                      f", bits at offset {offset}, frame_"
                                      f"major={fm}, {T_x}x{T_y}", got,
                                      want.transpose(1, 2) if fm else want)
        log(18, f"B={B} {T_x}x{T_y} with edge items (t_x=1, t_x=t_y, "
                f"t_x>t_y, t_x=0, full): mas_bits with 1, 2, 4 chains equal "
                f"to _forward_bits on every cell (0 off the band and on "
                f"invalid items; H1's from both layouts and plane forms, "
                f"H13's from both layouts, over garbage); H1's walk alone in both plane forms over "
                f"NaN; mas_backtrack cmp, stage, split, chains=2, "
                f"chains=4 bit-identical to _backtrack, mas_plain and the "
                f"fused H1 in both layouts, items 0, 1, 4, 5, 6 to the numpy "
                f"oracle; H11 indices equal to mas_walk_idx_plain over rows "
                f"of 0x7F7F7F7F, {unequal} unequal cells, fetches "
                f"{idx_fetches} (bits, then bytes of 3 and ones in row 0, at "
                f"offsets 0, 4, 1); H10, H12 and H14 left no NaN of the "
                f"pre-filled output; the same paths from bits with bytes of "
                f"3 and ones in row 0, and (H10, H14) from bits 4 and 1 "
                f"bytes off a 16-byte boundary; ring walk plans: "
                + " | ".join(plans))
    # The long form: a ring of many laps, from each fetch.
    value, t_x, t_y = ragged(22, 4, T_X, LONG_T_Y)
    v, tx, ty = (torch.from_numpy(a).to(dev) for a in (value, t_x, t_y))
    bits = mk.mas_bits(v, tx, ty)
    want = mk._backtrack(bits.permute(1, 0, 2) != 0, tx, ty)
    plans = []
    with two_pass_outputs_prefilled():
        err, unequal, idx_fetches = idx_walk_checks(
            mk, bits, tx, ty, f"long form B=4 {T_X}x{LONG_T_Y}")
        errs["mas_walk_idx_kernel"] = max(errs["mas_walk_idx_kernel"], err)
        for offset in (0, 4, 1):
            moved = shifted(bits, offset)
            plans.append(walk_plans(mk, moved))
            for (form, k), kernel in WALKS.items():
                if kernel not in RING_WALKS:
                    continue
                for fm in (False, True):
                    got = mk.mas_backtrack(moved, tx, ty, form=form, chains=k,
                                           frame_major=fm)
                    torch.cuda.synchronize()
                    require_equal(f"mas_backtrack form={form} chains={k}, "
                                  f"long form, bits at offset {offset}, "
                                  f"frame_major={fm}", got,
                                  want.transpose(1, 2) if fm else want)
                    errs[kernel] = max(errs[kernel], float(
                        (got - (want.transpose(1, 2) if fm else want))
                        .abs().max()))
    log(18, f"long form B=4 {T_X}x{LONG_T_Y} (t_y={t_y.tolist()}): "
            f"mas_backtrack stage, chains=2, chains=4 bit-identical to "
            f"_backtrack in both layouts over NaN, from bits at offsets 0, "
            f"4 and 1; H11 indices equal to mas_walk_idx_plain over rows of "
            f"0x7F7F7F7F, {unequal} unequal cells, fetches {idx_fetches}; "
            f"ring walk plans: " + " | ".join(plans))
    return errs


def fs_inputs(seed, dev, B=B_OTA, T_x=T_X, T_y=T_Y, t_x=None, t_y=None):
    """A forward-sum lattice [T_y, B, T_x] of log-softmax rows, ragged
    unless the lengths are given: (lp_tm, t_x, t_y)."""
    from aligner_tpu_torch.ops.forward_sum import _masked_logp
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T_y, T_x)).astype(np.float32) * 3
    if t_x is None:
        t_x = rng.integers(T_x // 2, T_x + 1, B).astype(np.int32)
        t_y = np.maximum(t_x, rng.integers(T_y // 4, T_y + 1, B)) \
            .astype(np.int32)
    tx = torch.from_numpy(t_x).to(dev)
    ty = torch.from_numpy(t_y).to(dev)
    lp = torch.log_softmax(torch.from_numpy(logits).to(dev), dim=-1)
    return _masked_logp(lp, tx).transpose(0, 1), tx, ty


def fs_grad_inputs(seed, dev, **shape):
    """H3's inputs on a lattice of `fs_inputs`: (lp_tm, alphas, total,
    t_x, t_y)."""
    from aligner_tpu_torch.ops.forward_sum import (_total_from_alphas,
                                                   _valid_items)
    from aligner_tpu_torch.ops.forward_sum_kernel import forward_sum_alpha
    lp_tm, tx, ty = fs_inputs(seed, dev, **shape)
    alphas, final = forward_sum_alpha(lp_tm, ty)
    total = torch.where(_valid_items(tx, ty), _total_from_alphas(final, tx),
                        0.0)
    return lp_tm, alphas, total, tx, ty


@contextlib.contextmanager
def alphas_prefilled_with_nan():
    """While active, H2 and H5 write into an output pre-filled with NaN
    (allocated uninitialised otherwise), so a cell they leave unwritten
    shows."""
    from aligner_tpu_torch.ops import forward_sum_kernel as fs
    from aligner_tpu_torch.ops import skip_dp_kernel as sk
    alphas_out = fs._alphas_out

    def prefilled(*args):
        return alphas_out(*args).fill_(float("nan"))

    with patched_attrs([(fs, "_alphas_out", prefilled),
                        (sk, "_alphas_out", prefilled)]):
        yield


def phase_forward_sum(dev):
    """H2's whole alpha lattice, frozen frames included, and its final
    column against alpha_plain, into an output pre-filled with NaN: the
    phase-7 batch; edge items (t_y = 0, t_y = 1, t_y = T_y, t_x = 1); a
    lattice read with a strided column; T_x = 1100 (two cells a thread).
    Returns the max abs error over the lattices."""
    from aligner_tpu_torch.ops.forward_sum_kernel import (alpha_plain,
                                                          forward_sum_alpha)
    lp_tm, tx, ty = fs_inputs(3, dev)
    t_x, t_y = tx.cpu().numpy(), ty.cpu().numpy()
    t_x[:4], t_y[:4] = [1, T_X // 2, T_X, 1], [0, 1, T_Y, T_Y // 3]
    edge = fs_inputs(3, dev, t_x=t_x, t_y=t_y)
    wide_t_y = np.array([1200, 700], np.int32)
    cases = {"ragged": (lp_tm, ty),
             "edge items": edge[::2],
             "strided column": (lp_tm.permute(1, 2, 0).contiguous()
                                .permute(2, 0, 1), ty),
             "T_x=1100": fs_inputs(5, dev, B=2, T_x=1100, T_y=1200,
                                   t_x=np.array([1100, 600], np.int32),
                                   t_y=wide_t_y)[::2]}
    max_err = 0.0
    with alphas_prefilled_with_nan():
        for what, (lp, t) in cases.items():
            alphas, final = forward_sum_alpha(lp, t)
            want = alpha_plain(lp, t)
            torch.cuda.synchronize()
            if not torch.allclose(alphas, want, rtol=FS_RTOL, atol=0):
                bad = ~torch.isclose(alphas, want, rtol=FS_RTOL, atol=0)
                raise AssertionError(f"H2 {what}: {int(bad.sum())} cells off "
                                     f"alpha_plain, first at "
                                     f"{bad.nonzero()[:4].tolist()}")
            if not torch.equal(final, alphas[-1]):
                raise AssertionError(f"H2 {what}: final column is not the "
                                     f"last alpha row")
            max_err = max(max_err, (alphas - want).abs().max().item())
    log(4, f"H2: whole alpha lattice (frozen frames included) within rtol "
           f"{FS_RTOL} of alpha_plain, written over NaN, final column equal "
           f"to the last row, for B={B_OTA} {T_X}x{T_Y} ragged, its edge "
           f"items (t_y = 0, 1, {T_Y}; t_x = 1), a strided column and B=2 "
           f"1100x1200 (two cells a thread); max abs error {max_err:.3g}")
    return max_err


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


def live_cells(t_x, t_y, skip=False):
    """Lattice cells that the valid items (1 <= t_x <= t_y) of a ragged
    batch need: t_x rows, or 2*t_x+1 states with `skip`, by t_y frames."""
    valid = (t_x >= 1) & (t_x <= t_y)
    rows = 2 * t_x + 1 if skip else t_x
    return int((rows.long() * t_y * valid).sum())


def bound(cells, in_lattices, out_bytes, ops_per_cell, sfu_per_cell=0):
    """(bound_ms, bound_by): the least time the card could take for one
    call. The largest of: the bytes it must move (each of the `cells` that
    the ragged items need read once per input lattice, and each output byte
    written once) over the card's memory rate; its operations on those
    cells over the card's float32 rate; and its expf, logf and log1pf on
    those cells over the card's special-function rate (each counted as one
    result of the unit, so this too is a floor)."""
    sfu_per_s = SFU_PER_CLOCK_PER_SM * SMS * max_sm_clock_hz()
    terms = {"bytes": (4 * in_lattices * cells + out_bytes)
             / PEAK_BYTES_PER_S * 1e3,
             "operations": ops_per_cell * cells / PEAK_F32_OPS_PER_S * 1e3,
             "sfu": sfu_per_cell * cells / sfu_per_s * 1e3}
    by = max(terms, key=terms.get)
    return terms[by], by


def byte_bound(in_bytes, out_bytes):
    """`bound` for a kernel whose arithmetic is nothing beside its bytes."""
    return (in_bytes + out_bytes) / PEAK_BYTES_PER_S * 1e3, "bytes"


def abba_ms(kernel, plain):
    """(kernel ms, plain ms) by CUDA events in the order plain, kernel,
    kernel, plain, which cancels drift in the clocks."""
    plain_ms = cuda_ms(plain, 2)
    ms = cuda_ms(kernel, 20)
    ms = (ms + cuda_ms(kernel, 20)) / 2
    return ms, (plain_ms + cuda_ms(plain, 2)) / 2


def phase_times(dev):
    """Each kernel's time, its plain version's and its bound, by kernel
    name, at the shapes the main paths use. No single PyTorch call
    computes MAS, a forward-sum lattice or its posterior (ctc_loss is
    another recursion and returns no lattice), so there is no library
    time to put beside them; the one exception is H12, whose function
    `torch.eq` computes in one call when given a float32 output."""
    from aligner_tpu_torch.ops import forward_sum_kernel as fs
    from aligner_tpu_torch.ops import mas_kernel as mk
    from aligner_tpu_torch.ops import mobo_kernel as mb
    from aligner_tpu_torch.ops import skip_dp_kernel as sk
    value, t_x, t_y = ragged(0, B_MAS, T_X, T_Y)
    v = torch.from_numpy(value).to(dev)
    tx = torch.from_numpy(t_x).to(dev)
    ty = torch.from_numpy(t_y).to(dev)
    flp_tm, ftx, fty = fs_inputs(3, dev)
    lp_tm, alphas, total, gtx, gty, _ = grad_inputs(dev)
    sv, stx, sty = (torch.from_numpy(a).to(dev)
                    for a in skip_viterbi_inputs())
    slp_tm, salphas, stotal, sgtx, sgty, _ = skip_fs_inputs(dev, 0.0)
    e_tm, mtx, mty = mobo_inputs(dev, 15, T_Y, D_MOBO)
    cells = mobo_cells(mtx, mty, D_MOBO)
    grid = 4 * T_X * B_OTA * (T_Y + 1)
    lattice = 4 * B_OTA * T_Y * T_X
    skip_lattice = 4 * B_OTA * T_Y * (2 * T_X + 1)
    two_pass, two_pass_modes = two_pass_runs(mk, v, tx, ty)
    # name: kernel call, plain call, (live cells, input lattices, output
    # bytes, operations per cell) or the bound itself, and the library call
    # where there is one
    runs = {
        "mas_kernel": (
            lambda: mk.mas_path(v, tx, ty), lambda: mk.mas_plain(v, tx, ty),
            (live_cells(tx, ty), 1, 4 * B_MAS * T_X * T_Y, 3)),
        "forward_sum_alpha_kernel": (
            lambda: fs.forward_sum_alpha(flp_tm, fty),
            lambda: fs.alpha_plain(flp_tm, fty),
            (live_cells(ftx, fty), 1, lattice + 4 * B_OTA * T_X, 8, 2)),
        "forward_sum_grad_kernel": (
            lambda: fs.forward_sum_grad(lp_tm, alphas, total, gtx, gty),
            lambda: fs.gamma_plain(lp_tm, alphas, total, gtx, gty),
            (live_cells(gtx, gty), 2, lattice, 13, 3)),
        "mas_skip_kernel": (
            lambda: sk.mas_skip_path(sv, stx, sty),
            lambda: sk.mas_skip_plain(sv, stx, sty),
            (live_cells(stx, sty, True), 1, skip_lattice, 5)),
        "forward_sum_skip_alpha_kernel": (
            lambda: sk.forward_sum_skip_alpha(slp_tm, sgty),
            lambda: sk.alpha_skip_plain(slp_tm, sgty),
            (live_cells(sgtx, sgty, True), 1,
             skip_lattice + 4 * B_OTA * (2 * T_X + 1), 16, 4)),
        "forward_sum_skip_gamma_kernel": (
            lambda: sk.forward_sum_skip_grad(slp_tm, salphas, stotal, sgtx,
                                             sgty),
            lambda: sk.gamma_skip_plain(slp_tm, salphas, stotal, sgtx, sgty),
            (live_cells(sgtx, sgty, True), 2, skip_lattice, 21, 5)),
        # Per live cell: the normalizer's window (D each of max, subtract,
        # exp and add, one log) and the same again for the inner LSE (H7,
        # H9) or D compares for the max (H8). Special functions per cell:
        # H2 and H3 one expf and one log1pf per logaddexp, H3 one more expf
        # for the posterior; H5 and H6 two logaddexp, H6 the posterior's
        # expf; H7 and H9 2 * (D expf + one logf), H8 D expf + one logf.
        "mobo_alpha_kernel": (
            lambda: mb.mobo_alpha(e_tm, mtx, D_MOBO),
            lambda: mb.mobo_alpha_plain(e_tm, mtx, D_MOBO),
            (cells, 1, grid, 8 * D_MOBO, 2 * (D_MOBO + 1))),
        "mobo_bp_kernel": (
            lambda: mb.mobo_bp(e_tm, mtx, mty, D_MOBO),
            lambda: mb.mobo_bp_plain(e_tm, mtx, mty, D_MOBO),
            (cells, 1, grid + 4 * B_OTA * T_X, 5 * D_MOBO, D_MOBO + 1)),
        "mobo_beta_kernel": (
            lambda: mb.mobo_beta(e_tm, mtx, mty, D_MOBO),
            lambda: mb.mobo_beta_plain(e_tm, mtx, mty, D_MOBO),
            (cells, 1, grid, 8 * D_MOBO, 2 * (D_MOBO + 1))),
        **two_pass,
    }
    plan = "C={}, w={}".format(*mb._cluster_plan(B_OTA, T_Y + 1, D_MOBO))
    # the sweeps over frames: the longest item's frames, which set the chain
    frames = {"mas_kernel": int(ty.max()),
              "forward_sum_alpha_kernel": int(fty.max()),
              "forward_sum_grad_kernel": int(gty.max()),
              "mas_skip_kernel": int(sty.max()),
              "forward_sum_skip_alpha_kernel": int(sgty.max()),
              "forward_sum_skip_gamma_kernel": int(sgty.max()),
              "mas_bits_chains_kernel": int(ty.max())}
    # the token sweeps: the longest item's tokens
    tokens = {name: int(mtx.clamp(max=T_X).max()) for name in MOBO_KERNELS}
    times = {}
    for name, (kernel, plain, work, *library) in runs.items():
        ms, plain_ms = abba_ms(kernel, plain)
        library_ms = cuda_ms(library[0], 20) if library else None
        bound_ms, bound_by = work if len(work) == 2 else bound(*work)
        times[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": library_ms}
        log(7, f"{name}: {ms:.4f} ms; plain version {plain_ms:.2f} ms; "
               f"bound {bound_ms:.4f} ms by {bound_by} "
               + (WALK_NOTE.format(frames=int(ty.max()))
                  if name in CHAIN_BOUND else
                  f"({100 * bound_ms / ms:.1f}% of the kernel's time)")
               + (f"; library call {library_ms:.4f} ms" if library else "")
               + (f"; cluster plan {plan}" if name in CLUSTER_KERNELS
                  else "")
               + (f"; {ms * 1e6 / frames[name]:.1f} ns a frame over the "
                  f"longest item's {frames[name]}" if name in frames
                  else "")
               + (f"; {ms * 1e6 / tokens[name]:.1f} ns a token over the "
                  f"longest item's {tokens[name]}" if name in tokens
                  else ""))
    posterior_times(dev)
    skip_viterbi_times(dev)
    mas_times(dev)
    log(7, f"mobo_bp_kernel's plan (C, w, z_shared, bytes) at B={B_OTA}: "
           f"{mb._bp_plan(B_OTA, T_X, T_Y + 1, D_MOBO)}")
    for B, D in ((64, D_MOBO), (B_SERVE, D_MOBO), (B_OTA, 1)):
        # H7-H9 at a smaller cluster, at one block per item (B > the card's
        # SMs), and with D = 1, where a token step is the chain's own cost
        # without its window.
        be_tm, btx, bty = mobo_inputs(dev, 15, T_Y, D, B)
        for name, kernel in (
                ("mobo_alpha_kernel", lambda: mb.mobo_alpha(be_tm, btx, D)),
                ("mobo_bp_kernel", lambda: mb.mobo_bp(be_tm, btx, bty, D)),
                ("mobo_beta_kernel",
                 lambda: mb.mobo_beta(be_tm, btx, bty, D))):
            log(7, f"{name} B={B} {T_X} tokens x {T_Y + 1} positions, D={D}: "
                   f"{cuda_ms(kernel, 20):.4f} ms; cluster plan "
                   "C={}, w={}".format(*mb._cluster_plan(B, T_Y + 1, D))
                   + (f"; H8's plan {mb._bp_plan(B, T_X, T_Y + 1, D)}"
                      if name == "mobo_bp_kernel" else ""))
    for what, (kernel, plain, work) in two_pass_modes.items():
        ms, plain_ms = abba_ms(kernel, plain)
        log(7, f"{what} B={B_MAS} {T_X}x{T_Y}: {ms:.4f} ms; plain version "
               f"{plain_ms:.2f} ms; bound {work[0]:.4f} ms by {work[1]}; "
               f"{ms * 1e6 / int(ty.max()):.1f} ns a frame over the longest "
               f"item's {int(ty.max())}")
    serving_times(dev)
    expand_device_times(dev)
    walk_device_times(dev)
    durs_ms = cuda_ms(lambda: mk.mas_durations(v, tx, ty), 20)
    durs_plain = cuda_ms(
        lambda: mk.mas_plain(v, tx, ty).sum(-1).to(torch.int32), 2)
    durs_bound, by = bound(live_cells(tx, ty), 1, 4 * B_MAS * T_X, 3)
    log(7, f"mas_kernel, durations mode B={B_MAS} {T_X}x{T_Y}: "
           f"{durs_ms:.4f} ms; plain version {durs_plain:.2f} ms; bound "
           f"{durs_bound:.4f} ms by {by}")
    log(7, f"shapes: H1 B={B_MAS} {T_X}x{T_Y}; H2, H3 B={B_OTA} "
           f"{T_X}x{T_Y}; H4-H6 B={B_OTA} {2 * T_X + 1} states x {T_Y}; "
           f"H7-H9 B={B_OTA} {T_X} tokens x {T_Y + 1} positions, D="
           f"{D_MOBO}, {cells} live cells; H10-H14 B={B_MAS} {T_X}x{T_Y}, "
           f"H13 and H14 with 4 chains; all ragged; no library call "
           f"computes any of them but H12 (torch.eq into a float32 output, "
           f"timed here and called nowhere in the package; H12's plain "
           f"version is the two-call expression compare + cast)")
    return times


def wall_ms(fn, reps):
    """Median host-clock ms of `reps` synchronised calls of fn() after one
    warm-up call: what a caller waits for."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def mas_times(dev):
    """H1 on phase 7's lattice read frame-major (rows) and with its plane
    forced into device memory, at the profiled training step's
    frame-major lattice (phase 9's first batch: its lengths, random
    values); H5 at T_s = 1041; each with the time per frame of the longest
    item. Then the serving walls (host clock, synchronised): maximum_path
    at B=32 beside H1's device time in it, and BatchAligner's align and
    align_durations on one request of 40 lattices."""
    import aligner_tpu_torch as at
    from aligner_tpu_torch.ops import mas_kernel as mk
    from aligner_tpu_torch.ops import skip_dp_kernel as sk
    from aligner_tpu_torch.utils.masks import lattice_mask
    value, t_x, t_y = ragged(0, B_MAS, T_X, T_Y)
    v, tx, ty = (torch.from_numpy(a).to(dev) for a in (value, t_x, t_y))
    frames = int(ty.max())
    fm_view = v.transpose(1, 2).contiguous().transpose(1, 2)
    runs = {"natural (tiles)": (lambda: mk.mas_path(v, tx, ty), True),
            "frame-major (rows)": (
                lambda: mk.mas_path(fm_view, tx, ty, frame_major=True),
                False)}
    for where in PLANES:
        with mas_planes_in(where):
            for layout, (run, contiguous) in runs.items():
                ms = cuda_ms(run, 20)
                log(7, f"mas_kernel, plane {where}, {layout}, B={B_MAS} "
                       f"{T_X}x{T_Y}: {ms:.4f} ms; {ms * 1e6 / frames:.1f} "
                       f"ns a frame over the longest item's {frames}; plan "
                       f"{mk._mas_plan(T_X, T_Y, contiguous)}")
    batch = train_batches()[0][0]
    B, T_x = batch["tokens"].shape
    T_y = batch["mel"].shape[1]
    btx, bty = (torch.as_tensor(np.asarray(batch[k], np.int32)).to(dev)
                for k in ("text_lengths", "mel_lengths"))
    rng = np.random.default_rng(16)
    fm = torch.from_numpy((rng.standard_normal((B, T_y, T_x)) * 3)
                          .astype(np.float32)).to(dev)
    require_equal("H1 at the training step's lattice vs mas_plain",
                  mk.mas_path(fm.transpose(1, 2), btx, bty,
                              frame_major=True),
                  mk.mas_plain(fm.transpose(1, 2), btx, bty)
                  .transpose(1, 2))
    ms = cuda_ms(lambda: mk.mas_path(fm.transpose(1, 2), btx, bty,
                                     frame_major=True), 20)
    log(7, f"mas_kernel at the profiled training step's lattice, B={B} "
           f"{T_x}x{T_y}, frame-major: {ms:.4f} ms; "
           f"{ms * 1e6 / int(bty.max()):.1f} ns a frame over the longest "
           f"item's {int(bty.max())}; plan {mk._mas_plan(T_x, T_y, False)}")
    lp_tm, _, _, _, sty, _ = skip_fs_inputs(dev, 0.0, T_X_WIDE)
    ms = cuda_ms(lambda: sk.forward_sum_skip_alpha(lp_tm, sty), 20)
    log(7, f"forward_sum_skip_alpha_kernel at B={B_OTA} "
           f"{2 * T_X_WIDE + 1} states x {T_Y}: {ms:.4f} ms; "
           f"{ms * 1e6 / int(sty.max()):.1f} ns a frame over the longest "
           f"item's {int(sty.max())}")
    mask = lattice_mask(tx, ty, T_X, T_Y)
    times = device_time_by_kernel(lambda: at.maximum_path(v, mask),
                                  iters=20, name_prefix="mas_kernel")
    path_ms, kernels = sum(times.values()) * 1e3, list(times)
    request = serving_requests()[0]
    aligner = at.BatchAligner(max_text=T_X, max_mel=T_Y, max_batch=32,
                              device=dev)
    walls = [wall_ms(run, 10) for run in (
        lambda: at.maximum_path(v, mask), lambda: aligner.align(request),
        lambda: aligner.align_durations(request))]
    log(7, f"serving walls (median of 10, synchronised): maximum_path "
           f"B={B_MAS} {T_X}x{T_Y} {walls[0]:.4f} ms (H1 {path_ms:.4f} ms "
           f"of device time in it, kernels {kernels}); BatchAligner on 40 "
           f"lattices: align {walls[1]:.4f} ms, align_durations "
           f"{walls[2]:.4f} ms")


def posterior_times(dev):
    """H3 at config 5's shape and at the profiled training step's lattice
    (phase 9's first batch: its lengths, random log-softmax rows), timed
    as in phase 7, with the time per frame of the longest item."""
    from aligner_tpu_torch.ops import forward_sum_kernel as fs
    batch = train_batches()[0][0]
    shapes = {"config 5": dict(B=B_LONG, T_y=T_Y_LONG),
              "the profiled training step": dict(
                  B=batch["tokens"].shape[0], T_x=batch["tokens"].shape[1],
                  T_y=batch["mel"].shape[1],
                  t_x=np.asarray(batch["text_lengths"], np.int32),
                  t_y=np.asarray(batch["mel_lengths"], np.int32))}
    for what, shape in shapes.items():
        lp_tm, alphas, total, tx, ty = fs_grad_inputs(10, dev, **shape)
        ms = cuda_ms(lambda: fs.forward_sum_grad(lp_tm, alphas, total, tx,
                                                 ty), 20)
        T_y, B, T_x = lp_tm.shape
        log(7, f"forward_sum_grad_kernel at {what}'s shape, B={B} "
               f"{T_x}x{T_y}: {ms:.4f} ms; {ms * 1e6 / int(ty.max()):.1f} "
               f"ns a frame over the longest item's {int(ty.max())}")


def skip_viterbi_times(dev):
    """H4 on phase 7's lattice with its move planes forced into device
    memory (the form of lattices whose planes do not fit in shared
    memory), and at the profiled pause train step's lattice (phase 13's
    first batch: its lengths, random values) read frame-major, as the
    pause model reads it, beside the same values state-major; with the
    time per frame of the longest item."""
    from aligner_tpu_torch.ops import skip_dp_kernel as sk
    sv, stx, sty = (torch.from_numpy(a).to(dev)
                    for a in skip_viterbi_inputs())
    frames = int(sty.max())
    with skip_planes_in_device_memory():
        ms = cuda_ms(lambda: sk.mas_skip_path(sv, stx, sty), 20)
    log(7, f"mas_skip_kernel, planes in device memory (forced) at B={B_OTA} "
           f"{2 * T_X + 1} states x {T_Y}: {ms:.4f} ms; "
           f"{ms * 1e6 / frames:.1f} ns a frame over the longest item's "
           f"{frames}")
    batch = pause_batches()[0]
    B, T_x = batch["tokens"].shape
    T_y, T_s = batch["mel"].shape[1], 2 * batch["tokens"].shape[1] + 1
    tx, ty = (torch.as_tensor(np.asarray(batch[k], np.int32)).to(dev)
              for k in ("text_lengths", "mel_lengths"))
    rng = np.random.default_rng(15)
    fm = torch.from_numpy((rng.standard_normal((B, T_y, T_s)) * 3)
                          .astype(np.float32)).to(dev)
    sm = fm.transpose(1, 2).contiguous()
    require_equal("H4 frame-major vs state-major",
                  sk.mas_skip_path(fm.transpose(1, 2), tx, ty,
                                   frame_major=True),
                  sk.mas_skip_path(sm, tx, ty).transpose(1, 2))
    for layout, frames_contiguous, run in (
            ("frame-major (the pause model's)", False,
             lambda: sk.mas_skip_path(fm.transpose(1, 2), tx, ty,
                                      frame_major=True)),
            ("state-major (serving's)", True,
             lambda: sk.mas_skip_path(sm, tx, ty))):
        ms = cuda_ms(run, 20)
        log(7, f"mas_skip_kernel at the profiled pause step's lattice, B={B} "
               f"{T_s} states x {T_y}, {layout}: {ms:.4f} ms; "
               f"{ms * 1e6 / int(ty.max()):.1f} ns a frame over the longest "
               f"item's {int(ty.max())}; plan (threads, cells, ring, planes, "
               f"fetch, shared bytes) "
               f"{sk._skip_viterbi_plan(T_s, T_y, frames_contiguous)}")


@contextlib.contextmanager
def skip_planes_in_device_memory():
    """While active, H4 keeps its move planes in device memory whatever
    the shape: its plan's threads, cells and fetch, with the ring of the
    device-memory plan for them."""
    from aligner_tpu_torch.ops import skip_dp_kernel as sk
    plan = sk._skip_viterbi_plan

    def device_memory_plan(T_s, T_y, frames_contiguous):
        threads, cells, _, _, fetch, _ = plan(T_s, T_y, frames_contiguous)
        ring = next(r for c, r, planes, f in sk.SKIP_VITERBI_PLANS
                    if (c, planes, f) == (cells, "global", fetch))
        return (threads, cells, ring, "global", fetch,
                sk._skip_viterbi_smem(threads * cells, ring, 0))

    with patched_attrs([(sk, "_skip_viterbi_plan", device_memory_plan)]):
        yield


def expand_device_times(dev):
    """H12 against its one library call (`torch.eq` into a float32
    output) at B=32 and B=256, 128x1024, by the profiler's device time of
    the kernel alone, beside CUDA events around each call."""
    from aligner_tpu_torch.ops import mas_kernel as mk
    for B in (B_MAS, B_SERVE):
        value, t_x, t_y = ragged(0, B, T_X, T_Y)
        v, tx, ty = (torch.from_numpy(a).to(dev) for a in (value, t_x, t_y))
        idx = mk.mas_walk_idx(mk.mas_bits(v, tx, ty), tx, ty)
        tokens = torch.arange(1, T_X + 1, dtype=torch.int32,
                              device=dev)[None, :, None]
        out = torch.empty((B, T_X, T_Y), dtype=torch.float32, device=dev)
        runs = {"H12": (lambda: mk.mas_expand(idx, T_X), "mas_expand_kernel"),
                "torch.eq": (lambda: torch.eq(tokens, idx[:, None, :],
                                              out=out), None)}
        require_equal(f"torch.eq into float32 vs H12, B={B}", runs["H12"][0](),
                      runs["torch.eq"][0]())
        line = []
        for name, (run, kernel) in runs.items():
            times = device_time_by_kernel(run, iters=50, name_prefix=kernel)
            ms, keys = sum(times.values()) * 1e3, [k[:60] for k in times]
            line.append(f"{name} {ms:.4f} ms of device time (kernels "
                        f"{keys}), {cuda_ms(run, 50):.4f} ms by events")
        log(7, f"mas_expand_kernel against its library call, B={B} "
               f"{T_X}x{T_Y}: " + "; ".join(line))


def walk_device_times(dev):
    """H1's walk alone, H10, H11 and H14 (2 and 4 chains) over the same
    bits at B=32 and B=256, 128x1024, by the profiler's device time of the
    kernel alone beside CUDA events around each call: at B=32 the events
    read the host's launch work for the call (about as long as the
    kernel) more than the card. H11 also beside its chain: the longest
    item's frames at H10's step by device time at B=32, where H10's time
    is its walker's chain (at B=256 it is the path's bytes)."""
    from aligner_tpu_torch.ops import mas_kernel as mk
    chain_ns = None
    for B in (B_MAS, B_SERVE):
        value, t_x, t_y = ragged(0, B, T_X, T_Y)
        v, tx, ty = (torch.from_numpy(a).to(dev) for a in (value, t_x, t_y))
        bits = mk.mas_bits(v, tx, ty)
        frames = int(ty.max())
        line, step_ns = [], {}
        for name, run, kernel in (
                ("H1 walk alone", lambda: mk.mas_backtrack(bits, tx, ty),
                 "mas_kernel"),
                ("H10", lambda: mk.mas_backtrack(bits, tx, ty, form="stage"),
                 "mas_walk_stage_kernel"),
                ("H11", lambda: mk.mas_walk_idx(bits, tx, ty),
                 "mas_walk_idx_kernel"),
                ("H14 K=2", lambda: mk.mas_backtrack(bits, tx, ty, chains=2),
                 "mas_walk_chains_kernel"),
                ("H14 K=4", lambda: mk.mas_backtrack(bits, tx, ty, chains=4),
                 "mas_walk_chains_kernel")):
            ms = measure_device_time(run, iters=50, name_prefix=kernel) * 1e3
            step_ns[name] = ms * 1e6 / frames
            line.append(f"{name} {ms:.4f} ms of device time "
                        f"({step_ns[name]:.1f} ns a frame), "
                        f"{cuda_ms(run, 50):.4f} ms by events")
        chain_ns = chain_ns or step_ns["H10"]
        log(7, f"walks by device time, B={B} {T_X}x{T_Y}: "
               + "; ".join(line) + f"; H11's chain at H10's B={B_MAS} step "
               f"{frames} frames x {chain_ns:.1f} ns = "
               f"{frames * chain_ns * 1e-6:.4f} ms")


# Kernels whose byte bound says nothing: one thread follows a chain of
# dependent steps and the kernel moves a few KB.
CHAIN_BOUND = ("mas_walk_idx_kernel",)
WALK_NOTE = ("(no share stated: what bounds it in fact is the ring walk's "
             "chain of up to {frames} dependent steps from shared memory "
             "per item; that chain at H10's step is logged with the walks' "
             "device times)")


def walk_plans(mk, bits):
    """H10's and H14's launch plans over `bits`, as they are logged."""
    B, T_y, T_x = bits.shape
    plan = [mk._walk_plan(T_x, T_y, k, bits.data_ptr()) for k in (1, 2, 4)]
    return (f"(threads, frames, stages, fetch, smem) H10 {plan[0]}, H14 "
            f"K=2 {plan[1]}, K=4 {plan[2]}")


def shifted(bits, offset):
    """A contiguous copy of `bits` whose data starts `offset` bytes past a
    16-byte boundary, so that the ring walk's plan takes another fetch."""
    buf = torch.empty(bits.numel() + 16, dtype=torch.uint8,
                      device=bits.device)
    out = buf[offset:offset + bits.numel()].view(bits.shape)
    out.copy_(bits)
    return out


def two_pass_runs(mk, v, tx, ty):
    """Phase 7's entries for the two-pass kernels on the lattice (v, tx,
    ty): ({kernel name: (kernel call, plain call, bound)}, the same for
    H1's two halves and the 2-chain variants, by description). H12's
    entry carries a fourth member, the library call of its function."""
    from aligner_tpu_torch.ops.mas_reference import MAX_NEG_VAL
    B, T_x, T_y = v.shape
    bits = mk.mas_bits(v, tx, ty)
    bits_tm = bits.permute(1, 0, 2) != 0
    idx = mk.mas_walk_idx(bits, tx, ty)
    cells = live_cells(tx, ty)
    frames = int((ty * mk._valid_items(tx, ty, T_x, T_y)).sum())
    path_bytes = 4 * B * T_x * T_y
    # The forward reads four bytes and writes one bit byte per live cell;
    # a walk reads one bit byte per frame and the path is written whole.
    forward = bound(cells, 1, cells, 3)
    walk = byte_bound(frames, path_bytes)

    def plain_bits():
        return mk._forward_bits(v, tx, ty, MAX_NEG_VAL)

    def plain_walk():
        return mk._backtrack(bits_tm, tx, ty)

    tokens = torch.arange(1, T_x + 1, dtype=torch.int32,
                          device=v.device)[None, :, None]

    def library_expand():
        out = torch.empty((B, T_x, T_y), dtype=torch.float32,
                          device=v.device)
        return torch.eq(tokens, idx[:, None, :], out=out)

    require_equal("torch.eq into float32 vs H12", library_expand(),
                  mk.mas_expand(idx, T_x))
    log(7, f"ring walk plans at B={B} {T_x}x{T_y}: {walk_plans(mk, bits)}")

    kernels = {
        "mas_walk_stage_kernel": (
            lambda: mk.mas_backtrack(bits, tx, ty, form="stage"),
            plain_walk, walk),
        "mas_walk_idx_kernel": (
            lambda: mk.mas_walk_idx(bits, tx, ty),
            lambda: mk.mas_walk_idx_plain(bits, tx, ty),
            byte_bound(frames, 4 * B * T_y)),
        "mas_expand_kernel": (
            lambda: mk.mas_expand(idx, T_x),
            lambda: mk.mas_expand_plain(idx, T_x),
            byte_bound(4 * B * T_y, path_bytes), library_expand),
        "mas_bits_chains_kernel": (
            lambda: mk.mas_bits(v, tx, ty, chains=4), plain_bits, forward),
        "mas_walk_chains_kernel": (
            lambda: mk.mas_backtrack(bits, tx, ty, chains=4), plain_walk,
            walk),
    }
    modes = {
        "mas_kernel, forward alone (mas_bits)": (
            lambda: mk.mas_bits(v, tx, ty), plain_bits, forward),
        "mas_kernel, walk alone (mas_backtrack, cmp)": (
            lambda: mk.mas_backtrack(bits, tx, ty), plain_walk, walk),
        "mas_bits_chains_kernel, 2 chains": (
            lambda: mk.mas_bits(v, tx, ty, chains=2), plain_bits, forward),
        "mas_walk_chains_kernel, 2 chains": (
            lambda: mk.mas_backtrack(bits, tx, ty, chains=2), plain_walk,
            walk),
    }
    return kernels, modes


def serving_times(dev):
    """The MAS kernels at the serving batch, B=256, timed as at B=32."""
    from aligner_tpu_torch.ops import mas_kernel as mk
    value, t_x, t_y = ragged(0, B_SERVE, T_X, T_Y)
    v, tx, ty = (torch.from_numpy(a).to(dev) for a in (value, t_x, t_y))
    kernels, modes = two_pass_runs(mk, v, tx, ty)
    fused = {"mas_kernel, fused (mas_path)": (
        lambda: mk.mas_path(v, tx, ty), lambda: mk.mas_plain(v, tx, ty),
        bound(live_cells(tx, ty), 1, 4 * B_SERVE * T_X * T_Y, 3))}
    for what, (kernel, plain, work, *library) in {**fused, **modes,
                                                  **kernels}.items():
        ms, plain_ms = abba_ms(kernel, plain)
        if what in TWO_PASS_KERNELS and "chains" in what:
            what += ", 4 chains"
        log(7, f"{what} B={B_SERVE} {T_X}x{T_Y}: {ms:.4f} ms; plain version "
               f"{plain_ms:.2f} ms; bound {work[0]:.4f} ms by {work[1]}; "
               f"{ms * 1e6 / int(ty.max()):.1f} ns a frame over the longest "
               f"item's {int(ty.max())}"
               + (f"; library call {cuda_ms(library[0], 20):.4f} ms"
                  if library else ""))


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
    with gamma_prefilled_with_nan():
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
           f"t_x=0, NEG band, dead frame, -inf), into an output pre-filled "
           f"with NaN: within rtol {GRAD_RTOL} / "
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


TOKEN_KERNELS = ("mas_kernel", "forward_sum_alpha_kernel",
                 "forward_sum_grad_kernel")
SKIP_KERNELS = ("mas_skip_kernel", "forward_sum_skip_alpha_kernel",
                "forward_sum_skip_gamma_kernel")
MOBO_KERNELS = ("mobo_alpha_kernel", "mobo_bp_kernel", "mobo_beta_kernel")
PACKAGE_KERNELS = (TOKEN_KERNELS + SKIP_KERNELS + MOBO_KERNELS
                   + TWO_PASS_KERNELS)
CLUSTER_KERNELS = ("mobo_alpha_kernel", "mobo_beta_kernel")


def require_launches(where, launches, at_least, names=TOKEN_KERNELS):
    for name in names:
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


def profile_step(phase, name, step, state, batch, reps=5):
    """One train step under torch.profiler: device time per step by
    kernel, and the device's idle share against the same steps issued
    back to back with one synchronise at the end."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step(state, batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step(state, batch)
        torch.cuda.synchronize()
    kernels = sorted(((e.self_device_time_total / 1e3 / reps, e.count / reps,
                       e.key) for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and not e.is_user_annotation), reverse=True)
    busy = sum(ms for ms, _, _ in kernels)
    if not busy > 0:
        raise AssertionError(f"{name}: the profiler saw no device time")
    top = "; ".join(f"{key[:48]} {ms:.4f} ms x{count:g}"
                    for ms, count, key in kernels[:8])
    # the package's own kernels, by name, wherever they rank
    named = ((key.split("::", 1)[-1].split("(")[0].split("<")[0], ms, count)
             for ms, count, key in kernels)
    ours = "; ".join(f"{name} {ms:.4f} ms x{count:g}"
                     for name, ms, count in named if name in PACKAGE_KERNELS)
    log(phase, f"profile of the {name} step over {reps} steps: back to back "
               f"{wall:.4f} ms per step, device busy {busy:.4f} ms (idle "
               f"share {1 - busy / wall:.3f}) in "
               f"{sum(c for _, c, _ in kernels):g} device operations; "
               f"largest: {top}; the package's kernels: {ours}")
    return wall, busy


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

    step = make_train_step(fresh, bin_start=0, bin_ramp=1)
    step16 = step_ms(step, restored, batch, 10)
    profile16 = profile_step(9, f"pause-blind B={B_OTA}", step, restored,
                             batch)
    long_model = at.OTAAligner(config, device=dev)
    long_state = create_train_state(long_model, learning_rate=LR)
    long_batch = config5_batch(dev)
    long_step = make_train_step(long_model, bin_start=0, bin_ramp=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    at.reset_kernel_launches()
    step64 = step_ms(long_step, long_state, long_batch, 3)
    require_launches("config-5 step", at.kernel_launches(), 4)
    profile64 = profile_step(9, f"float32 config 5 (B={B_LONG} x "
                                f"{T_Y_LONG})", long_step, long_state,
                             long_batch, reps=3)
    peak64 = torch.cuda.max_memory_allocated(dev) / 2**30
    log(9, f"step time (host clock, synchronised, median): B={B_OTA} "
           f"T_mel<={T_Y} {step16:.2f} ms over 10 steps; B={B_LONG} "
           f"T_mel={T_Y_LONG} {step64:.2f} ms over 3 steps; peak device "
           f"memory of the config-5 steps {peak64:.2f} GiB")
    return (launches, step_wall, (step16, profile16),
            (step64, *profile64, peak64))


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


def run_demo(phase, dev, *args):
    """Run one demo subcommand of the package's CLI on the card and
    return the JSON record on its last line."""
    cmd = [sys.executable, "-m", "aligner_tpu_torch", *args,
           "--steps", str(DEMO_STEPS), "--device", dev.type]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(cmd[1:])} exited "
                             f"{proc.returncode}:\n{proc.stdout}"
                             f"{proc.stderr}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    log(phase, f"{' '.join(cmd[3:])} in {time.perf_counter() - t0:.1f} s: "
               f"{json.dumps(rec)}")
    return rec


def phase_demo(dev):
    rec = run_demo(10, dev, "demo-ota")
    if rec.get("demo") != "ota" or not {"duration_exact", "duration_mae",
                                        "boundary_f1_tol2"} <= set(rec):
        raise AssertionError(f"demo-ota printed {rec}")


def phase_demo_pauses(dev):
    rec = run_demo(14, dev, "demo-pauses", "--skip-blind")
    aware = rec.get("pause_aware", {})
    if rec.get("demo") != "pauses" or "pause_blind" in rec or not {
            "token_boundary_f1_tol2", "pause_precision"} <= set(aware):
        raise AssertionError(f"demo-pauses printed {rec}")


def skip_viterbi_inputs():
    """The skip Viterbi's inputs at B=16, 257 states x 1024 frames,
    state-major and ragged, with edge items 0-5: t_x = 1; t_x = t_y;
    t_x > t_y; t_x = 0; an all-zero lattice (ties everywhere); a full-size
    item (t_x > 63, where the state index leaves int8's range)."""
    rng = np.random.default_rng(10)
    T_s = 2 * T_X + 1
    value = (rng.standard_normal((B_OTA, T_s, T_Y)) * 3).astype(np.float32)
    t_x = rng.integers(T_X // 2, T_X + 1, B_OTA).astype(np.int32)
    t_y = np.maximum(t_x, rng.integers(T_Y // 4, T_Y + 1, B_OTA)) \
        .astype(np.int32)
    t_x[:6] = [1, T_X, T_X, 0, 3 * T_X // 4, T_X]
    t_y[:6] = [T_Y, T_X, T_X // 2, T_Y // 2, T_Y // 2, T_Y]
    value[4] = 0.0
    return value, t_x, t_y


def phase_skip_mas(dev):
    """H4 against mas_skip_plain on the card and the numpy oracle, with its
    move planes in shared memory (the 257 x 1024 batch, as planned) and in
    device memory (the same batch forced; the 1041 x 1200 wide case, as
    planned), both layouts each; returns the max abs difference from the
    oracle (0 or the phase fails)."""
    from aligner_tpu_torch.ops.skip_dp import mas_skip_path_frame_major
    from aligner_tpu_torch.ops.skip_dp_kernel import (_skip_viterbi_plan,
                                                      mas_skip_path,
                                                      mas_skip_plain)
    from aligner_tpu_torch.ops.skip_dp_reference import mas_skip_single
    value, t_x, t_y = skip_viterbi_inputs()
    v, tx, ty = (torch.from_numpy(a).to(dev) for a in (value, t_x, t_y))
    v_fm = v.transpose(1, 2).contiguous()
    T_s = 2 * T_X + 1
    plans = {layout: _skip_viterbi_plan(T_s, T_Y, layout == "state-major")
             for layout in ("state-major", "frame-major")}
    if [p[3:5] for p in plans.values()] != [("shared", "tiles"),
                                            ("shared", "rows")]:
        raise AssertionError(f"H4 at {T_s} x {T_Y}: plans {plans}")
    max_err = 0.0
    for cost in ENTER_COSTS:
        want = mas_skip_plain(v, tx, ty, enter_cost=cost)
        path = mas_skip_path(v, tx, ty, enter_cost=cost)
        torch.cuda.synchronize()
        require_equal(f"H4 cost {cost} vs mas_skip_plain", path, want)
        if path[2:4].any():
            raise AssertionError("H4: invalid items must get zero paths")
        require_equal(f"H4 cost {cost} from a frame-major lattice",
                      mas_skip_path_frame_major(v_fm, tx, ty,
                                                enter_cost=cost),
                      want.transpose(1, 2))
        with skip_planes_in_device_memory():
            require_equal(f"H4 cost {cost}, planes in device memory",
                          mas_skip_path(v, tx, ty, enter_cost=cost), want)
            require_equal(f"H4 cost {cost}, planes in device memory, from a "
                          f"frame-major lattice",
                          mas_skip_path_frame_major(v_fm, tx, ty,
                                                    enter_cost=cost),
                          want.transpose(1, 2))
        got = path.cpu().numpy().astype(np.int32)
        for i in (0, 1, 4, 5):
            oracle = mas_skip_single(value[i], int(t_x[i]), int(t_y[i]),
                                     enter_cost=cost)
            max_err = max(max_err, float(np.abs(got[i] - oracle).max()))
            if not np.array_equal(got[i], oracle):
                raise AssertionError(f"H4 cost {cost} item {i} vs oracle")
        log(11, f"H4 enter_cost {cost}: B={B_OTA} {T_s} states x {T_Y}, "
                f"planes in shared memory as planned and in device memory "
                f"(forced), state-major (tiles) and frame-major (rows), "
                f"bit-identical to mas_skip_plain in both layouts, "
                f"items 0, 1, 4, 5 (t_x = 1, t_x = t_y, ties, t_x = {T_X}) "
                f"to the numpy oracle; invalid items (t_x > t_y, t_x = 0) "
                f"all zero")
    rng = np.random.default_rng(11)
    T_s = 2 * T_X_WIDE + 1
    wide = torch.from_numpy(rng.standard_normal(
        (2, T_s, 1200)).astype(np.float32)).to(dev)
    wtx = torch.tensor([T_X_WIDE, 300], dtype=torch.int32, device=dev)
    wty = torch.tensor([1200, 700], dtype=torch.int32, device=dev)
    plan = _skip_viterbi_plan(T_s, 1200, True)
    if plan[3:5] != ("global", "rows"):
        raise AssertionError(f"H4 at {T_s} x 1200: plan {plan}")
    want = mas_skip_plain(wide, wtx, wty, enter_cost=-1.2)
    require_equal("H4 wide", mas_skip_path(wide, wtx, wty, enter_cost=-1.2),
                  want)
    require_equal("H4 wide from a frame-major lattice",
                  mas_skip_path_frame_major(
                      wide.transpose(1, 2).contiguous(), wtx, wty,
                      enter_cost=-1.2), want.transpose(1, 2))
    wtx[1] = T_X_WIDE + 1        # more states than the lattice has
    if mas_skip_path(wide, wtx, wty)[1].any():
        raise AssertionError("H4: an oversize item must get a zero path")
    log(11, f"H4 wide B=2 {T_s} states x 1200 (two cells a thread, plan "
            f"(threads, cells, ring, planes, fetch, shared bytes) {plan}): "
            f"bit-identical to mas_skip_plain in both layouts; an item "
            f"with 2*t_x+1 > T_s gets a zero path")
    return max_err


def skip_fs_inputs(dev, cost, T_x=T_X):
    """The skip beta sweep's inputs at B=16, 2*T_x+1 states (257 unless
    given) x 1024 frames, ragged, with the edge items of `grad_inputs`:
    (lp_tm, alphas, total, t_x, t_y, log_probs); alphas from H5. Items
    0-5: t_y = 1; t_x > t_y; t_x = 0; a NEG-saturated diagonal band; a
    fully dead frame; -inf inputs."""
    from aligner_tpu_torch.ops.forward_sum import _masked_logp
    from aligner_tpu_torch.ops.skip_dp import (_total_from_alphas_skip,
                                               _valid_items_skip, n_states)
    from aligner_tpu_torch.ops.skip_dp_kernel import (NEG,
                                                      forward_sum_skip_alpha)
    rng = np.random.default_rng(12)
    T_s = 2 * T_x + 1
    logits = torch.from_numpy(
        rng.standard_normal((B_OTA, T_Y, T_s)).astype(np.float32) * 3)
    lp = torch.log_softmax(logits, dim=-1).numpy()
    t_x = rng.integers(T_x // 2, T_x + 1, B_OTA).astype(np.int32)
    t_y = np.maximum(t_x, rng.integers(T_Y // 4, T_Y + 1, B_OTA)) \
        .astype(np.int32)
    t_x[0], t_y[0] = 1, 1
    t_x[1], t_y[1] = T_x, T_x // 2
    t_x[2] = 0
    center = np.arange(T_Y)[:, None] * (2 * t_x[3] + 1) // t_y[3]
    lp[3] = np.where(np.abs(np.arange(T_s)[None, :] - center) <= 3, lp[3],
                     NEG)
    lp[4, t_y[4] // 2, :] = NEG
    lp[5] = np.where(rng.random((T_Y, T_s)) < 0.1, -np.inf, lp[5])
    log_probs = torch.from_numpy(lp).to(dev)
    tx = torch.from_numpy(t_x).to(dev)
    ty = torch.from_numpy(t_y).to(dev)
    lp_tm = _masked_logp(log_probs, n_states(tx)).transpose(0, 1)
    alphas, final = forward_sum_skip_alpha(lp_tm, ty, cost)
    total = torch.where(_valid_items_skip(tx, ty, T_s),
                        _total_from_alphas_skip(final, tx), 0.0)
    return lp_tm, alphas, total, tx, ty, log_probs


def phase_skip_sums(dev):
    """H5 against alpha_skip_plain (also at T_s = 1041) and H6 against
    gamma_skip_plain on the same inputs, both over NaN, with each enter
    cost, and the skip loss's gradient through autograd (kernel route)
    against the plain versions'; returns both max abs errors."""
    from aligner_tpu_torch.ops.skip_dp import (_valid_items_skip,
                                               forward_sum_skip_loss)
    from aligner_tpu_torch.ops.skip_dp_kernel import (NEG, alpha_skip_plain,
                                                      forward_sum_skip_grad,
                                                      gamma_skip_plain)
    alpha_err = gamma_err = 0.0
    # H5 alone at T_s = 1041 (two cells a thread), its lattice over NaN.
    for cost in ENTER_COSTS:
        with alphas_prefilled_with_nan():
            lp_tm, alphas, _, _, ty, _ = skip_fs_inputs(dev, cost, T_X_WIDE)
        want_alphas = alpha_skip_plain(lp_tm, ty, cost)
        torch.testing.assert_close(alphas, want_alphas, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
        carries = want_alphas > 0.5 * NEG
        alpha_err = max(alpha_err, (alphas - want_alphas)[carries]
                        .abs().max().item())
        log(12, f"H5 enter_cost {cost}: B={B_OTA} {2 * T_X_WIDE + 1} states "
                f"x {T_Y} with the edge items, written over NaN: within rtol "
                f"{GRAD_RTOL} / atol {GRAD_ATOL} of alpha_skip_plain over "
                f"the whole lattice (max abs err {alpha_err:.3g})")
    for cost in ENTER_COSTS:
        with alphas_prefilled_with_nan():
            lp_tm, alphas, total, tx, ty, log_probs = skip_fs_inputs(dev,
                                                                     cost)
        want_alphas = alpha_skip_plain(lp_tm, ty, cost)
        with gamma_prefilled_with_nan():
            gamma = forward_sum_skip_grad(lp_tm, alphas, total, tx, ty,
                                          cost)
        want = gamma_skip_plain(lp_tm, alphas, total, tx, ty, cost)
        torch.cuda.synchronize()
        if not torch.isfinite(gamma).all():
            raise AssertionError("H6: gamma is not finite")
        torch.testing.assert_close(alphas, want_alphas, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
        torch.testing.assert_close(gamma, want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
        ys = torch.arange(T_Y, device=dev)[:, None, None]
        live = (ys < ty[None, :, None]) & (lp_tm > 0.5 * NEG)
        if gamma[~live].any():
            raise AssertionError("H6: gamma is not 0 off the live cells")
        # alphas of dead cells sit near NEG = -1e15, where one ulp is
        # 6.7e7: report the error on the cells that carry mass.
        carries = want_alphas > 0.5 * NEG
        alpha_err = max(alpha_err, (alphas - want_alphas)[carries]
                        .abs().max().item())
        gamma_err = max(gamma_err, (gamma - want).abs().max().item())
        x = log_probs.clone().requires_grad_()
        forward_sum_skip_loss(x, tx, ty, enter_cost=cost).sum().backward()
        valid = _valid_items_skip(tx, ty, lp_tm.shape[2])
        torch.testing.assert_close(
            x.grad, -want.transpose(0, 1) * valid[:, None, None],
            rtol=GRAD_RTOL, atol=GRAD_ATOL)
        log(12, f"H5, H6 enter_cost {cost}: B={B_OTA} {2 * T_X + 1} states "
                f"x {T_Y} with edge items (t_y=1, t_x>t_y, t_x=0, NEG "
                f"band, dead frame, -inf), both into outputs pre-filled with "
                f"NaN: within rtol {GRAD_RTOL} / atol "
                f"{GRAD_ATOL} of alpha_skip_plain and gamma_skip_plain (max "
                f"abs err {alpha_err:.3g} and {gamma_err:.3g}), gamma 0 "
                f"off {int((~live).sum())} dead cells; "
                f"forward_sum_skip_loss backward on the card equals the "
                f"plain versions' gradient")
    return alpha_err, gamma_err


@contextlib.contextmanager
def plain_versions_refused():
    """While active, every plain version raises: the CUDA path must not
    reach one."""
    from aligner_tpu_torch.ops import (forward_sum_kernel, mas_kernel,
                                       mobo_kernel, skip_dp_kernel)

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the CUDA path")

    patched = [(mas_kernel, "mas_plain"),
               (mas_kernel, "_forward_bits"),
               (mas_kernel, "_backtrack"),
               (mas_kernel, "mas_walk_idx_plain"),
               (mas_kernel, "mas_expand_plain"),
               (forward_sum_kernel, "alpha_plain"),
               (forward_sum_kernel, "gamma_plain"),
               (skip_dp_kernel, "mas_skip_plain"),
               (skip_dp_kernel, "alpha_skip_plain"),
               (skip_dp_kernel, "gamma_skip_plain"),
               (mobo_kernel, "mobo_alpha_plain"),
               (mobo_kernel, "mobo_bp_plain"),
               (mobo_kernel, "mobo_beta_plain")]
    with patched_attrs([(module, name, refuse) for module, name in patched]):
        yield


@contextlib.contextmanager
def patched_attrs(patches):
    """Set each (module, name, value) while active and restore it after."""
    saved = [getattr(module, name) for module, name, _ in patches]
    for module, name, value in patches:
        setattr(module, name, value)
    try:
        yield
    finally:
        for (module, name, _), value in zip(patches, saved):
            setattr(module, name, value)


def skip_requests():
    """Three requests of 40 ragged state-major lattices, up to 257 states
    x 1024 frames."""
    rng = np.random.default_rng(13)
    requests = []
    for _ in range(3):
        lats = []
        for _ in range(40):
            tx = int(rng.integers(1, T_X + 1))
            ty = int(rng.integers(tx, T_Y + 1))
            lats.append((rng.standard_normal((2 * tx + 1, ty)) * 3)
                        .astype(np.float32))
        requests.append(lats)
    return requests


def pause_batches():
    """Silence-bearing synthetic corpus (a pause with probability 0.4 per
    token gap, none in the transcript) at the CLI width, bucketed to full
    batches of B=16 with T_x <= 128 and T_mel <= 1024."""
    from aligner_tpu_torch.data import (SyntheticConfig, bucket_batches,
                                        make_corpus)
    cfg = SyntheticConfig(vocab_size=VOCAB, n_mels=N_MELS,
                          min_tokens=3 * T_X // 4 + 1, max_tokens=T_X,
                          min_duration=4, max_duration=6, pause_prob=0.4,
                          seed=14)
    batches = bucket_batches(make_corpus(PAUSE_UTTERANCES, cfg), B_OTA,
                             shuffle_seed=14)
    return [b for b in batches if len(b["tokens"]) == B_OTA
            and b["mel"].shape[1] <= T_Y]


def phase_pause_path(dev, blind_step_ms):
    """Drive the pause-aware entry points with every plain version
    refused; return the kernel launches made there."""
    import aligner_tpu_torch as at
    from aligner_tpu_torch.ops.skip_dp_kernel import mas_skip_plain
    from aligner_tpu_torch.ops.skip_dp_reference import mas_skip_single
    from aligner_tpu_torch.train import (create_train_state,
                                         make_train_step,
                                         restore_checkpoint)
    from aligner_tpu_torch.train.loop import train_aligner
    config = at.OTAConfig(vocab_size=VOCAB, n_mels=N_MELS, dim=DIM,
                          hidden=HIDDEN, use_recon=True, model_pauses=True)
    requests = skip_requests()
    aligner = at.SkipBatchAligner(max_text=T_X, max_mel=T_Y, max_batch=B_OTA,
                                  device=dev)
    model = at.OTAAligner(config, device=dev,
                          generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.pause_key.normal_(std=0.1)
    batch = ota_inputs(dev)
    batches = pause_batches()
    if len(batches) < 3:
        raise AssertionError(f"only {len(batches)} full pause batches")
    trained = at.OTAAligner(config, device=dev)
    anneal = TRAIN_STEPS // 2

    def curriculum(step_no):                     # -3 -> 0, as demo-pauses
        return {"pause_bias": -3.0 + 3.0 * min(step_no / anneal, 1.0)}

    lines = []
    torch.cuda.synchronize()
    at.reset_kernel_launches()
    with plain_versions_refused(), tempfile.TemporaryDirectory() as ckpt:
        t0 = time.perf_counter()
        served = [aligner.align(r) for r in requests]
        torch.cuda.synchronize()
        after_serving = at.kernel_launches()
        with torch.no_grad():
            ota = model(*batch, pause_bias=-0.5)
        torch.cuda.synchronize()
        after_forward = at.kernel_launches()
        state, history = train_aligner(
            trained, batches, steps=TRAIN_STEPS, device=dev,
            learning_rate=LR, bin_start=BIN_START, bin_ramp=BIN_RAMP,
            log_every=1, checkpoint_dir=ckpt, apply_extra=curriculum,
            log_fn=lambda line: lines.append((time.perf_counter(), line)))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = at.kernel_launches()
        fresh = at.OTAAligner(config, device=dev,
                              generator=torch.Generator().manual_seed(1))
        restored = restore_checkpoint(ckpt, create_train_state(
            fresh, learning_rate=LR))
        live = trained.state_dict()
        for key, value in fresh.state_dict().items():
            if not torch.equal(value, live[key]):
                raise AssertionError(f"restored {key} differs")
        first = {k: torch.as_tensor(v).to(dev)
                 for k, v in batches[0].items()}
        step = make_train_step(fresh, bin_start=0, bin_ramp=1,
                               apply_extra=curriculum)
        pause_step_ms = step_ms(step, restored, first, 10)
        pause_profile = profile_step(13, f"pause B={B_OTA}", step, restored,
                                     first)
    slices = sum(-(-len(r) // B_OTA) for r in requests)
    shapes = sorted({tuple(b["mel"].shape[:2]) for b in batches})
    log(13, f"SkipBatchAligner 3x40 requests, pause OTA forward B={B_OTA} "
            f"at {VOCAB}/{N_MELS}/{DIM}/{HIDDEN} f32, train_aligner "
            f"{TRAIN_STEPS} steps on {len(batches)} silence-bearing batches "
            f"of [B, T_mel] {shapes} with the pause_bias curriculum, in "
            f"{seconds:.2f} s, no plain version reached; kernel launches "
            f"{launches}")
    if after_serving != {"mas_skip_kernel": slices}:
        raise AssertionError(f"SkipBatchAligner launched {after_serving}, "
                             f"expected {slices} of mas_skip_kernel")
    forward = {k: after_forward.get(k, 0) - after_serving.get(k, 0)
               for k in SKIP_KERNELS}
    if forward != {"mas_skip_kernel": 1, "forward_sum_skip_alpha_kernel": 1,
                   "forward_sum_skip_gamma_kernel": 0}:
        raise AssertionError(f"the pause OTA forward launched {forward}")
    training = {k: launches.get(k, 0) - after_forward.get(k, 0)
                for k in SKIP_KERNELS}
    require_launches("pause training", training, TRAIN_STEPS, SKIP_KERNELS)
    if set(launches) != set(SKIP_KERNELS):
        raise AssertionError(f"the pause path launched {set(launches)}")

    for r, (lats, results) in enumerate(zip(requests, served)):
        for start in range(0, len(lats), B_OTA):
            group = lats[start:start + B_OTA]
            value = np.zeros((B_OTA, 2 * T_X + 1, T_Y), np.float32)
            tx = np.zeros(B_OTA, np.int32)
            ty = np.zeros(B_OTA, np.int32)
            for i, lat in enumerate(group):
                tx[i], ty[i] = (lat.shape[0] - 1) // 2, lat.shape[1]
                value[i, :lat.shape[0], :ty[i]] = lat
            want = mas_skip_plain(torch.from_numpy(value).to(dev),
                                  torch.from_numpy(tx).to(dev),
                                  torch.from_numpy(ty).to(dev)).cpu().numpy()
            for i, lat in enumerate(group):
                ts = lat.shape[0]
                w = want[i, :ts, :ty[i]]
                path, tok, pause = results[start + i]
                if not (np.array_equal(path, w)
                        and np.array_equal(tok, w.sum(-1)[1::2])
                        and np.array_equal(pause, w.sum(-1)[0::2])):
                    raise AssertionError(
                        f"SkipBatchAligner request {r} item {start + i}")
        for i in np.argsort([lat.size for lat in lats])[:4]:
            lat = lats[i]
            oracle = mas_skip_single(lat, (lat.shape[0] - 1) // 2,
                                     lat.shape[1])
            if not np.array_equal(results[i][0], oracle):
                raise AssertionError(
                    f"SkipBatchAligner request {r} item {i} vs oracle")
    log(13, "SkipBatchAligner: 3 requests x 40 lattices equal to "
            "mas_skip_plain, the 4 smallest of each to the numpy oracle")

    tokens, mel, tl, ml = batch
    for key, val in ota.items():
        if not torch.isfinite(val).all():
            raise AssertionError(f"pause OTA {key} is not finite")
    logp = ota["logp_with_prior"]
    if logp.shape != (B_OTA, T_Y, 2 * T_X + 1):
        raise AssertionError(f"pause OTA lattice is {tuple(logp.shape)}")
    require_equal("pause OTA hard_path vs mas_skip_plain", ota["hard_path"],
                  mas_skip_plain(logp.transpose(1, 2), tl, ml)
                  .transpose(1, 2))
    frames = ota["durations"].sum(-1) + ota["pause_durations"].sum(-1)
    if not torch.equal(frames, ml.float()):
        raise AssertionError("pause OTA durations and pause durations do "
                             "not sum to the mel lengths")
    plain_loss = plain_skip_loss(logp, tl, ml)
    got = ota["loss_forward_sum"]
    if not torch.allclose(got, plain_loss, rtol=FS_RTOL, atol=0):
        raise AssertionError(f"pause OTA loss_forward_sum {got.item()} vs "
                             f"plain {plain_loss.item()}")
    log(13, f"pause OTA: hard_path bit-identical to mas_skip_plain on its "
            f"logp_with_prior; loss_forward_sum {got.item():.6f} vs plain "
            f"{plain_loss.item():.6f}; token and pause durations sum to the "
            f"mel lengths ({int(ota['pause_durations'].sum())} pause "
            f"frames); loss_bin {ota['loss_bin'].item():.4f}, loss_recon "
            f"{ota['loss_recon'].item():.4f}")

    train = [r for r in history if "loss" in r]
    for rec in history:
        if not all(np.isfinite(v) for v in rec.values()):
            raise AssertionError(f"a metric is not finite: {rec}")
    if len(train) != TRAIN_STEPS or restored.step != TRAIN_STEPS + 22:
        raise AssertionError(f"{len(train)} train records, restored and "
                             f"timed state at step {restored.step}")
    if not train[-1]["loss"] < train[0]["loss"]:
        raise AssertionError(f"loss did not fall: {train[0]['loss']} -> "
                             f"{train[-1]['loss']}")
    if not trained.pause_key.abs().max() > 0:
        raise AssertionError("the pause key did not move")
    stamps = [t for t, _ in lines]
    step_wall = statistics.median(
        (b - a) * 1e3 for a, b in zip(stamps[3:], stamps[4:]))
    log(13, f"pause training: loss {train[0]['loss']:.4f} -> "
            f"{train[-1]['loss']:.4f} (forward-sum "
            f"{train[0]['loss_forward_sum']:.4f} -> "
            f"{train[-1]['loss_forward_sum']:.4f}); checkpoint restored "
            f"with equal parameters; median wall {step_wall:.2f} ms per "
            f"step in the loop; synchronised step, median of 10: pause "
            f"model {pause_step_ms:.2f} ms at {tuple(first['mel'].shape[:2])}"
            f" beside the pause-blind model's {blind_step_ms:.2f} ms")
    return launches, pause_step_ms, pause_profile


def plain_skip_loss(logp, tl, ml):
    """loss_forward_sum of a pause lattice from alpha_skip_plain."""
    from aligner_tpu_torch.ops.forward_sum import _masked_logp
    from aligner_tpu_torch.ops.skip_dp import (_total_from_alphas_skip,
                                               _valid_items_skip, n_states)
    from aligner_tpu_torch.ops.skip_dp_kernel import alpha_skip_plain
    alphas = alpha_skip_plain(
        _masked_logp(logp, n_states(tl)).transpose(0, 1), ml)
    total = _total_from_alphas_skip(alphas[-1], tl)
    valid = _valid_items_skip(tl, ml, logp.shape[2])
    return torch.mean(-torch.where(valid, total, 0.0) / ml.clamp(min=1))


def mobo_inputs(dev, seed, T_y, D, B=B_OTA):
    """The MoBo sweeps' inputs at B items (16 unless given), 128 tokens x
    T_y frames, ragged and feasible (t_x <= t_y <= t_x * D), with edge
    items 0-3: t_x = 1; a full item (t_x = T_X, t_y = T_y, the end position
    is the grid's last); an item without a boundary sequence (t_y > t_x *
    D); t_x = 0. Returns the token-major grid of _prep_energies and the
    lengths."""
    from aligner_tpu_torch.ops.mobo import _prep_energies
    rng = np.random.default_rng(seed)
    energies = rng.standard_normal((B, T_y, T_X)).astype(np.float32)
    t_x = rng.integers(T_X // 2, T_X + 1, B).astype(np.int32)
    t_y = np.clip(rng.integers(T_y // 4, T_y + 1, B), t_x,
                  np.minimum(t_x * D, T_y)).astype(np.int32)
    t_x[:4] = [1, T_X, 4, 0]
    t_y[:4] = [min(D, T_y) - 1, T_y, min(4 * D + 40, T_y), T_y // 2]
    tx = torch.from_numpy(t_x).to(dev)
    ty = torch.from_numpy(t_y).to(dev)
    return _prep_energies(torch.from_numpy(energies).to(dev), tx, ty), tx, ty


def mobo_feasible(t_x, t_y, D):
    return (t_x >= 1) & (t_x <= t_y) & (t_y <= t_x * D)


def mobo_cells(t_x, t_y, D):
    """Grid cells that the items with a boundary sequence need: t_x
    tokens by t_y + 1 positions."""
    return int((t_x.long() * (t_y + 1) * mobo_feasible(t_x, t_y, D)).sum())


@contextlib.contextmanager
def plain_route():
    """While active, the MoBo ops take the plain versions on any device:
    the reference that the kernels' route is held against."""
    from aligner_tpu_torch.ops import mobo, mobo_kernel
    with patched_attrs([
            (mobo, "mobo_alpha", mobo_kernel.mobo_alpha_plain),
            (mobo, "mobo_bp", mobo_kernel.mobo_bp_plain),
            (mobo, "mobo_beta", mobo_kernel.mobo_beta_plain)]):
        yield


def require_live_close(name, got, want):
    """Live cells (above NEG / 2 in the plain version) within MOBO_RTOL /
    MOBO_ATOL, dead cells below NEG / 2 on both sides; returns the max abs
    difference on live cells."""
    from aligner_tpu_torch.ops.mobo_kernel import NEG
    live = want > 0.5 * NEG
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: not finite")
    torch.testing.assert_close(got[live], want[live], rtol=MOBO_RTOL,
                               atol=MOBO_ATOL)
    if not (got[~live] <= 0.5 * NEG).all():
        raise AssertionError(f"{name}: a dead cell rose above NEG / 2")
    return (got[live] - want[live]).abs().max().item() if live.any() else 0.0


def mobo_grads(energies, tx, ty, D, weights):
    """Gradients in the energies of a weighted sum over every output of
    mobo_forward, and of mobo_loss, on the items that `weights` keeps."""
    from aligner_tpu_torch.ops.mobo import mobo_forward, mobo_loss
    from aligner_tpu_torch.ops.mobo_kernel import NEG
    keep, w_g, w_d, w_p = weights
    x = energies.clone().requires_grad_()
    out = mobo_forward(x, tx, ty, D)
    lb = torch.where(out["log_boundaries"] > 0.5 * NEG,
                     out["log_boundaries"], 0.0)
    ((out["loss"] * keep).sum()
     + (w_g * out["soft_alignment"] * keep[:, None, None]).sum()
     + (w_d * out["expected_durations"] * keep[:, None]).sum()
     + (w_p * lb * keep[:, None, None]).sum()).backward()
    y = energies[keep > 0].clone().requires_grad_()
    mobo_loss(y, tx[keep > 0], ty[keep > 0], D).backward()
    return x.grad, y.grad


@contextlib.contextmanager
def mobo_bp_prefilled():
    """While active, H8's outputs start as garbage (backpointers -7,
    durations -1), so a cell it leaves unwritten shows."""
    from aligner_tpu_torch.ops import mobo_kernel as mb
    outs = mb._bp_outs
    with patched_attrs([(mb, "_bp_outs", lambda *args: tuple(
            o.fill_(v) for o, v in zip(outs(*args), (-7, -1))))]):
        yield


def require_bp(D, bp, durs, want_bp, want_durs, tx, ty):
    """H8's backpointers on tokens < t_x and durations equal to the plain
    version's, 0 past t_x, and the durations of a feasible item tiling its
    frames in steps of 1..D; returns the count of unequal backpointers."""
    T_x = bp.shape[0]
    xs = torch.arange(T_x, device=bp.device)[:, None, None]
    live_tokens = (xs < tx[None, :, None]).expand_as(bp)
    unequal = float((bp != want_bp)[live_tokens].sum())
    require_equal(f"H8 backpointers D={D}", bp * live_tokens,
                  want_bp * live_tokens)
    if bp[~live_tokens].any():
        raise AssertionError("H8: a token >= t_x has a backpointer")
    require_equal(f"H8 durations D={D}", durs, want_durs)
    ok = mobo_feasible(tx, ty, D)
    inside = (xs[:, 0].T < tx[:, None])
    if not (torch.equal(durs.sum(1)[ok], ty[ok].long())
            and ((durs >= 1) & (durs <= D))[inside & ok[:, None]].all()
            and not durs[~inside].any()):
        raise AssertionError(f"H8 D={D}: durations of a feasible item do "
                             f"not tile its frames in steps of 1..D")
    return unequal


def phase_mobo_kernels(dev):
    """H7, H8 and H9 against their plain versions on the card at each of
    MOBO_SHAPES (seed, B, T_y, D): the main path's shape, a small window,
    a slice barely wider than D, and B = 64 where the cluster is smaller.
    Returns their max abs differences (H8: the count of unequal
    backpointers)."""
    from aligner_tpu_torch.ops import mobo_kernel as mb
    errs = [0.0, 0.0, 0.0]
    for seed, B, T_y, D in MOBO_SHAPES:
        e_tm, tx, ty = mobo_inputs(dev, seed, T_y, D, B)
        logB = mb.mobo_alpha(e_tm, tx, D)
        betas = mb.mobo_beta(e_tm, tx, ty, D)
        want_bp, want_durs = mb.mobo_bp_plain(e_tm, tx, ty, D)
        with mobo_bp_prefilled():
            bp, durs = mb.mobo_bp(e_tm, tx, ty, D)
            torch.cuda.synchronize()
        errs[1] = max(errs[1], require_bp(D, bp, durs, want_bp, want_durs,
                                          tx, ty))
        alpha_err = require_live_close(
            "H7", logB, mb.mobo_alpha_plain(e_tm, tx, D))
        beta_err = require_live_close(
            "H9", betas, mb.mobo_beta_plain(e_tm, tx, ty, D))
        errs[0] = max(errs[0], alpha_err)
        errs[2] = max(errs[2], beta_err)
        ok = mobo_feasible(tx, ty, D)
        total = logB[-1].gather(1, ty.long()[:, None])[:, 0]
        if not (torch.equal(total > 0.5 * mb.NEG, ok)
                and torch.isfinite(total).all()):
            raise AssertionError(f"H7 D={D}: the log-marginal is live on "
                                 f"{(total > 0.5 * mb.NEG).tolist()}, the "
                                 f"items with a boundary sequence are "
                                 f"{ok.tolist()}")
        rng = np.random.default_rng(seed + 100)
        energies = e_tm[:, :, 1:].permute(1, 2, 0).contiguous()
        weights = (ok.float(), *(torch.from_numpy(rng.standard_normal(shape)
                                                  .astype(np.float32)).to(dev)
                                 for shape in ((B, T_y, T_X), (B, T_X),
                                               (B, T_X, T_y))))
        got = mobo_grads(energies, tx, ty, D, weights)
        with plain_route():
            want = mobo_grads(energies, tx, ty, D, weights)
        torch.cuda.synchronize()
        for name, g, w in zip(("mobo_forward", "mobo_loss"), got, want):
            if not torch.isfinite(g).all():
                raise AssertionError(f"{name} backward is not finite")
            torch.testing.assert_close(g, w, rtol=MOBO_GRAD_RTOL,
                                       atol=MOBO_GRAD_ATOL)
        grad_err = max((g - w).abs().max().item() for g, w in zip(got, want))
        C, w = mb._cluster_plan(B, T_y + 1, D)
        log(15, f"H7, H8, H9 D={D}: B={B} {T_X} tokens x {T_y + 1} "
                f"positions with edge items (t_x=1, full, no boundary "
                f"sequence, t_x=0); H7, H8 and H9 in clusters of C={C} "
                f"blocks of w={w} positions (H8's plan (C, w, z_shared, "
                f"bytes) {mb._bp_plan(B, T_X, T_y + 1, D)}): "
                f"live cells within rtol {MOBO_RTOL} / atol "
                f"{MOBO_ATOL} of mobo_alpha_plain and mobo_beta_plain (max "
                f"abs err {alpha_err!r} and {beta_err!r}), dead cells "
                f"below NEG / 2; H8 over garbage: backpointers on "
                f"tokens < t_x and durations equal to mobo_bp_plain's, 0 "
                f"past t_x, each feasible item's durations tiling t_y; mobo_forward's and mobo_loss's "
                f"backward within rtol {MOBO_GRAD_RTOL} / atol "
                f"{MOBO_GRAD_ATOL} of the plain route's (max abs err "
                f"{grad_err:.3g})")
    return errs


def mobo_objective(out, step_no):
    """The MoBo training objective of the train command: reconstruction
    pins the boundaries, the boundary NLL shapes the energies."""
    return (out["loss_recon"] + 0.1 * out["loss_mobo"],
            {"loss_mobo": out["loss_mobo"], "loss_recon": out["loss_recon"]})


def romo_objective(out, step_no):
    return (out["loss_recon"] + 0.1 * out["loss"],
            {"loss_rough": out["loss_rough"],
             "loss_refine": out["loss_refine"],
             "loss_recon": out["loss_recon"],
             "refine_feasible": out["refine_feasible"].float().mean()})


def no_hard_decode(step_no):
    return {"compute_hard": False}


@contextlib.contextmanager
def adjoint_timed(times):
    """While active, each call of the MoBo adjoint is synchronised before
    and after and its host-clock milliseconds are appended to `times`."""
    from aligner_tpu_torch.ops import mobo
    adjoint = mobo._mobo_ab_adjoint

    def timed(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grad = adjoint(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return grad

    with patched_attrs([(mobo, "_mobo_ab_adjoint", timed)]):
        yield


def phase_mobo_path(dev):
    """Drive the MoBo and RoMo entry points with every plain version
    refused; return the kernel launches made there."""
    import aligner_tpu_torch as at
    from aligner_tpu_torch.train import (create_train_state,
                                         make_train_step,
                                         restore_checkpoint)
    from aligner_tpu_torch.train.checkpoint import load_run_config
    from aligner_tpu_torch.train.loop import train_aligner
    width = dict(vocab_size=VOCAB, n_mels=N_MELS, dim=DIM, hidden=HIDDEN,
                 max_duration=D_MOBO, use_recon=True)
    families = {
        "MoBo": (at.MoBoAligner, at.MoBoConfig(**width), mobo_objective,
                 {"mobo_alpha_kernel": 1, "mobo_beta_kernel": 1}),
        "RoMo": (at.RoMoAligner, at.RoMoConfig(window=WINDOW_ROMO, **width),
                 romo_objective,
                 {"forward_sum_alpha_kernel": 1, "forward_sum_grad_kernel": 1,
                  "mobo_alpha_kernel": 1, "mobo_beta_kernel": 1}),
    }
    batches, _ = train_batches()
    first = {k: torch.as_tensor(v).to(dev) for k, v in batches[0].items()}
    inputs = [first[k] for k in ("tokens", "mel", "text_lengths",
                                 "mel_lengths")]
    total = {}
    for family, (cls, config, objective, per_step) in families.items():
        model = cls(config, device=dev,
                    generator=torch.Generator().manual_seed(0))
        trained = cls(config, device=dev)
        lines = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        at.reset_kernel_launches()
        with plain_versions_refused(), tempfile.TemporaryDirectory() as ckpt:
            t0 = time.perf_counter()
            with torch.no_grad():
                out = model(*inputs)
            torch.cuda.synchronize()
            forward = at.kernel_launches()
            state, history = train_aligner(
                trained, batches, steps=TRAIN_STEPS, device=dev,
                learning_rate=LR, log_every=1, checkpoint_dir=ckpt,
                apply_extra=no_hard_decode, objective=objective,
                log_fn=lambda line: lines.append((time.perf_counter(), line)))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = at.kernel_launches()
            model_class = load_run_config(ckpt)["model_class"]
            fresh = cls(config, device=dev,
                        generator=torch.Generator().manual_seed(1))
            restored = restore_checkpoint(ckpt, create_train_state(
                fresh, learning_rate=LR))
            trained_params = trained.state_dict()
            for key, value in fresh.state_dict().items():
                if not torch.equal(value, trained_params[key]):
                    raise AssertionError(f"{family}: restored {key} differs")
            step = make_train_step(fresh, apply_extra=no_hard_decode,
                                   objective=objective)
            sync_ms = step_ms(step, restored, first, 10)
            adjoint_ms = []
            with adjoint_timed(adjoint_ms):
                timed_ms = step_ms(step, restored, first, 5)
            profile_step(16, f"{family} B={B_OTA}", step, restored, first)
        for name in launches:
            total[name] = total.get(name, 0) + launches[name]
        shapes = sorted({tuple(b["mel"].shape[:2]) for b in batches})
        log(16, f"{family}Aligner forward B={B_OTA} at "
                f"{VOCAB}/{N_MELS}/{DIM}/{HIDDEN} f32, D={D_MOBO}"
                f"{f', window {WINDOW_ROMO}' if family == 'RoMo' else ''}, "
                f"use_recon, with hard boundaries; train_aligner "
                f"{TRAIN_STEPS} steps on {len(batches)} batches of "
                f"[B, T_mel] {shapes}, in {seconds:.2f} s, no plain version "
                f"reached; kernel launches {launches}")
        want_forward = {**per_step, "mobo_bp_kernel": 1}
        if forward != want_forward:
            raise AssertionError(f"the {family} forward launched {forward}, "
                                 f"expected {want_forward}")
        training = {k: launches[k] - forward.get(k, 0) for k in launches}
        if training != {**{k: n * TRAIN_STEPS for k, n in per_step.items()},
                        "mobo_bp_kernel": 0}:
            raise AssertionError(f"{family} training launched {training}")
        if model_class != family or restored.step != TRAIN_STEPS + 28:
            raise AssertionError(f"config.json says {model_class!r}; the "
                                 f"restored and timed state is at step "
                                 f"{restored.step}")

        with plain_route(), torch.no_grad():
            want = model(*inputs)
        torch.cuda.synchronize()
        tl, ml = first["text_lengths"], first["mel_lengths"]
        feasible = out.get("refine_feasible",
                           mobo_feasible(tl, ml, D_MOBO))
        if not torch.equal(feasible, want.get("refine_feasible", feasible)):
            raise AssertionError(f"{family}: refine_feasible differs from "
                                 f"the plain route's")
        if not feasible.any():
            raise AssertionError(f"{family}: no item is feasible")
        for key, val in out.items():
            got_f, want_f = val, want[key]
            if val.ndim and val.shape[0] == len(feasible):
                got_f, want_f = val[feasible], want[key][feasible]
            if key == "log_boundaries":    # dead cells hold about NEG
                live = want_f > -1e14
                got_f, want_f = got_f[live], want_f[live]
            if not torch.isfinite(got_f.float()).all():
                raise AssertionError(f"{family} {key} is not finite")
            if key.startswith("hard_") or val.dtype == torch.bool:
                require_equal(f"{family} {key} vs the plain route", got_f,
                              want_f)
            else:
                torch.testing.assert_close(got_f, want_f, rtol=1e-5,
                                           atol=1e-5)
        durs = out["hard_durations"][feasible]
        if not torch.equal(durs.sum(1), ml[feasible].long()):
            raise AssertionError(f"{family}: hard durations do not sum to "
                                 f"the mel lengths")
        if not torch.equal(out["hard_path"].sum(1)[feasible].int(), durs):
            raise AssertionError(f"{family}: hard_path and hard_durations "
                                 f"disagree")
        train = [r for r in history if "loss" in r]
        for rec in history:
            if not all(np.isfinite(v) for v in rec.values()):
                raise AssertionError(f"a metric is not finite: {rec}")
        if len(train) != TRAIN_STEPS:
            raise AssertionError(f"{len(train)} train records")
        if not train[-1]["loss"] < train[0]["loss"]:
            raise AssertionError(f"{family} loss did not fall: "
                                 f"{train[0]['loss']} -> {train[-1]['loss']}")
        stamps = [t for t, _ in lines]
        step_wall = statistics.median(
            (b - a) * 1e3 for a, b in zip(stamps[3:], stamps[4:]))
        adjoint = statistics.median(adjoint_ms)
        log(16, f"{family}: forward equal to the plain route's on "
                f"{int(feasible.sum())} feasible items of {B_OTA} (soft "
                f"outputs rtol 1e-5 / atol 1e-5, hard outputs equal, "
                f"durations sum to the mel lengths); loss "
                f"{train[0]['loss']:.4f} -> {train[-1]['loss']:.4f} (recon "
                f"{train[0]['loss_recon']:.4f} -> "
                f"{train[-1]['loss_recon']:.4f}); checkpoint restored with "
                f"equal parameters, model_class {model_class!r}; median wall "
                f"{step_wall:.2f} ms per step in the loop; synchronised "
                f"step, median of 10, {sync_ms:.2f} ms at "
                f"{tuple(first['mel'].shape[:2])}; with the adjoint "
                f"synchronised apart, median of 5: step {timed_ms:.2f} ms, "
                f"adjoint {adjoint:.2f} ms ({adjoint / timed_ms:.3f} of "
                f"it); peak device memory "
                f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    return total


def phase_demo_mobo(dev):
    rec = run_demo(17, dev, "demo-mobo")
    if rec.get("demo") != "mobo" or not {"duration_exact", "duration_mae",
                                         "boundary_f1_tol2"} <= set(rec):
        raise AssertionError(f"demo-mobo printed {rec}")
    rec = run_demo(17, dev, "demo-romo")
    if rec.get("demo") != "romo" or not {"refine_feasible", "rough",
                                         "refined"} <= set(rec):
        raise AssertionError(f"demo-romo printed {rec}")


def run_bench_mas(dev, batch):
    """`bench-mas --route all` on the card as a subprocess; returns its
    JSON records, one per route, none with an error."""
    from aligner_tpu_torch.bench_mas import METRIC, ROUTES
    cmd = [sys.executable, "-m", "aligner_tpu_torch", "bench-mas", "--route",
           "all", "--batch", str(batch), "--device", dev.type]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(cmd[1:])} exited "
                             f"{proc.returncode}:\n{proc.stdout}"
                             f"{proc.stderr}")
    recs = [json.loads(line) for line in proc.stdout.strip().splitlines()]
    keys = {"metric", "value", "unit", "vs_baseline", "p50_align_step_ms",
            "config", "timing_method", "route", "device"}
    if [r.get("route") for r in recs] != list(ROUTES) \
            or recs[-1]["route"] != "fused":
        raise AssertionError(f"bench-mas printed routes "
                             f"{[r.get('route') for r in recs]}")
    for rec in recs:
        if "error" in rec or not keys <= set(rec) \
                or rec["metric"] != METRIC or not rec["value"] > 0 \
                or rec["timing_method"] != "cuda_events" \
                or f"B={batch}," not in rec["config"]:
            raise AssertionError(f"bench-mas printed {rec}")
        log(19, f"bench-mas {json.dumps(rec)}")
    log(19, f"{' '.join(cmd[3:])}: {len(recs)} routes behind the two-seed "
            f"bit-identity gate in {time.perf_counter() - t0:.1f} s")
    return recs


def phase_two_pass_path(dev):
    """Drive every route of the two-pass path at the serving batch with
    every plain version refused; return the kernel launches made there."""
    import aligner_tpu_torch as at
    from aligner_tpu_torch.bench_mas import ROUTES
    from aligner_tpu_torch.ops.mas_kernel import mas_path
    from aligner_tpu_torch.ops.mas_reference import mas_single
    bits_walk = {"mas_bits_chains_kernel": 1, "mas_walk_chains_kernel": 1}
    expected = {
        "fused": {"mas_kernel": 1},
        "two_pass": {"mas_kernel": 2},
        "stage": {"mas_kernel": 1, "mas_walk_stage_kernel": 1},
        "split": {"mas_kernel": 1, "mas_walk_idx_kernel": 1,
                  "mas_expand_kernel": 1},
        "chains2": bits_walk, "chains4": bits_walk}
    value, t_x, t_y = ragged(20, B_SERVE, T_X, T_Y)
    t_x[:2], t_y[:2] = [T_X, 0], [T_X // 2, T_Y // 2]     # invalid items
    v, tx, ty = (torch.from_numpy(a).to(dev) for a in (value, t_x, t_y))
    paths, total = {}, {}
    torch.cuda.synchronize()
    at.reset_kernel_launches()
    t0 = time.perf_counter()
    with plain_versions_refused():
        for name, options in ROUTES.items():
            before = at.kernel_launches()
            paths[name] = mas_path(v, tx, ty, **options)
            after = at.kernel_launches()
            made = {k: after[k] - before.get(k, 0) for k in after
                    if after[k] != before.get(k, 0)}
            if made != expected[name]:
                raise AssertionError(f"route {name} launched {made}, "
                                     f"expected {expected[name]}")
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = at.kernel_launches()
    log(19, f"mas_path on every route ({', '.join(ROUTES)}) at B={B_SERVE} "
            f"{T_X}x{T_Y} ragged in {seconds:.3f} s, no plain version "
            f"reached; kernel launches {launches}")
    require_launches("two-pass path", launches, 1,
                     ("mas_kernel", *TWO_PASS_KERNELS))
    fused = paths["fused"]
    for name, path in paths.items():
        require_equal(f"route {name} vs the fused kernel", path, fused)
    if fused[:2].any():
        raise AssertionError("invalid items must get zero paths")
    frames = torch.arange(T_Y, device=dev)[None, :] < ty[:, None]
    frames[:2] = False
    if not torch.equal(fused.sum(1), frames.float()):
        raise AssertionError("a frame below t_y is not on exactly one token")
    for i in (2, 3, B_SERVE // 2, B_SERVE - 1):
        oracle = mas_single(value[i].copy(), int(t_x[i]), int(t_y[i]))
        if not np.array_equal(fused[i].cpu().numpy().astype(np.int32),
                              oracle):
            raise AssertionError(f"fused path item {i} vs oracle")
    log(19, f"every route bit-identical to the fused kernel, which equals "
            f"the numpy oracle on items 2, 3, {B_SERVE // 2}, "
            f"{B_SERVE - 1}; each frame below t_y on exactly one token; "
            f"invalid items all zero")
    for batch in (B_MAS, B_SERVE):
        run_bench_mas(dev, batch)
    return launches



WAV_UTTERANCES, WAV_STEPS = 64, 300       # phase 20's corpora and runs
WAV_MODEL_FLAGS = ()                      # the CLI's default width
WAV_RUNS = (
    ("ota", "char", ["--recon", "--temperature", "0.15"], TOKEN_KERNELS),
    ("pauses", "phone", ["--model-pauses", "--tokenizer", "phone"],
     SKIP_KERNELS),
    ("romo", "phone", ["--model", "romo", "--tokenizer", "phone"],
     ("forward_sum_alpha_kernel", "forward_sum_grad_kernel") + MOBO_KERNELS),
    ("bf16", "char", ["--recon", "--temperature", "0.15", "--compute-dtype",
                      "bfloat16"], TOKEN_KERNELS))
CONFIG_KEYS = {"model_class", "model_config", "tokenizer", "train_seed",
               "shuffle"}


def make_wav_corpora(root):
    """The two seeded corpora of scripts/make_wav_corpus.py, built side by
    side: characters without pauses, and phone transcripts with a pause
    after a token with probability 0.4."""
    here = os.path.dirname(os.path.abspath(__file__))
    corpora = {"char": os.path.join(root, "char"),
               "phone": os.path.join(root, "phone")}
    extra = {"char": [], "phone": ["--pause-prob", "0.4", "--transcripts",
                                   "phone"]}
    procs = {k: subprocess.Popen(
        [sys.executable, os.path.join(here, "scripts", "make_wav_corpus.py"),
         path, "--utterances", str(WAV_UTTERANCES), "--seed", "0",
         *extra[k]], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for k, path in corpora.items()}
    for k, proc in procs.items():
        out, _ = proc.communicate(timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"make_wav_corpus.py ({k}) exited "
                                 f"{proc.returncode}:\n{out}")
    return corpora


def read_records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def check_alignments(name, corpus, ckpt, out, textgrids, tokenizer):
    """One record and one TextGrid per utterance, frames conserved
    (tokens and pauses), and the config.json keys."""
    from aligner_tpu_torch.data import PhoneTokenizer, load_metadata
    from aligner_tpu_torch.models import MoBoConfig, OTAConfig, RoMoConfig
    texts = dict(load_metadata(corpus))
    recs = read_records(out)
    if sorted(r["utt_id"] for r in recs) != sorted(texts):
        raise AssertionError(f"{name}: {len(recs)} records for "
                             f"{len(texts)} utterances")
    grids = sorted(os.listdir(textgrids))
    if grids != sorted(f"{u}.TextGrid" for u in texts):
        raise AssertionError(f"{name}: {len(grids)} TextGrids")
    exact = 0
    for r in recs:
        n_tokens = len(texts[r["utt_id"]].split() if tokenizer == "phone"
                       else texts[r["utt_id"]])
        frames = sum(r["durations"]) + sum(r.get("pauses", []))
        if len(r["durations"]) != n_tokens or \
                ("pauses" in r) != (name == "pauses"):
            raise AssertionError(f"{name}: record {r}")
        exact += frames == r["n_frames"]
        # RoMo's infeasible items take their rounded rough durations,
        # which may miss the frame count by less than a frame a token.
        if frames != r["n_frames"] and (
                name != "romo" or abs(frames - r["n_frames"]) > n_tokens):
            raise AssertionError(f"{name}: {frames} frames aligned of "
                                 f"{r['n_frames']} ({r['utt_id']})")
    with open(os.path.join(ckpt, "config.json")) as f:
        cfg = json.load(f)
    keys = CONFIG_KEYS | ({"tokenizer_vocab"} if tokenizer == "phone"
                          else set())
    fields = {"ota": OTAConfig, "pauses": OTAConfig, "bf16": OTAConfig,
              "romo": RoMoConfig, "mobo": MoBoConfig}[name]
    if set(cfg) != keys or set(cfg["model_config"]) != set(
            fields.__dataclass_fields__) or cfg["tokenizer"] != (
            PhoneTokenizer.__name__ if tokenizer == "phone"
            else "CharTokenizer"):
        raise AssertionError(f"{name}: config.json {cfg}")
    if (cfg["model_config"].get("compute_dtype") == "bfloat16") != (
            name == "bf16"):
        raise AssertionError(f"{name}: compute_dtype in config.json {cfg}")
    return recs, exact


def card_vs_cpu_log_mel(corpus, dev, n=4):
    """Max abs difference of the card's log-mel (cuFFT) from the CPU's
    (pocketfft) on the corpus's first n utterances."""
    from aligner_tpu_torch.data import load_metadata, read_wav
    from aligner_tpu_torch.ops.mel import MelConfig, log_mel_spectrogram
    err = 0.0
    for utt_id, _ in list(load_metadata(corpus))[:n]:
        _, wav = read_wav(os.path.join(corpus, "wavs", f"{utt_id}.wav"))
        wav = torch.from_numpy(wav)[None]
        want = log_mel_spectrogram(wav, MelConfig())
        got = log_mel_spectrogram(wav.to(dev), MelConfig()).cpu()
        torch.testing.assert_close(got, want, rtol=0, atol=MEL_ATOL)
        err = max(err, (got - want).abs().max().item())
    return err


def phase_wav(dev):
    """The wav pipeline: `train` then `align` through the CLI on two
    seeded corpora with every plain version refused, for OTA, the pause
    model and RoMo; return the kernel launches made there."""
    import aligner_tpu_torch as at
    from aligner_tpu_torch import cli
    from aligner_tpu_torch.score_wav import score
    t_phase = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        corpora = make_wav_corpora(root)
        log(20, f"two corpora of {WAV_UTTERANCES} utterances "
                f"(scripts/make_wav_corpus.py --seed 0; the second with "
                f"--pause-prob 0.4 --transcripts phone) in "
                f"{time.perf_counter() - t0:.1f} s")
        err = card_vs_cpu_log_mel(corpora["char"], dev)
        log(20, f"log-mel on the card (cuFFT) against the CPU (pocketfft) "
                f"on 4 utterances: max abs err {err:.3g} (atol {MEL_ATOL})")
        outs = {}
        for name, tokenizer, flags, kernels in WAV_RUNS:
            corpus = corpora[tokenizer]
            ckpt = os.path.join(root, f"ck_{name}")
            out = os.path.join(root, f"{name}.jsonl")
            textgrids = os.path.join(root, f"tg_{name}")
            torch.cuda.synchronize()
            at.reset_kernel_launches()
            with plain_versions_refused():
                times = cli.cmd_train(cli.build_parser().parse_args(
                    ["train", corpus, "--checkpoint-dir", ckpt, "--steps",
                     str(WAV_STEPS), *WAV_MODEL_FLAGS, *flags,
                     "--device", str(dev)]))
                t0 = time.perf_counter()
                cli.main(["align", corpus, "--checkpoint-dir", ckpt,
                          "--output", out, "--textgrid-dir", textgrids,
                          "--device", str(dev)])
                torch.cuda.synchronize()
                align_s = time.perf_counter() - t0
            run = at.kernel_launches()
            require_launches(f"wav {name}", run, 1, kernels)
            for k, v in run.items():
                launches[k] = launches.get(k, 0) + v
            recs, exact = check_alignments(name, corpus, ckpt, out,
                                           textgrids, tokenizer)
            outs[name] = (corpus, ckpt, out, recs)
            log(20, f"{name} ({' '.join(flags)}): corpus load "
                    f"{times['load_s']:.3f} s for {times['utterances']} "
                    f"utterances, {times['steps']} steps in "
                    f"{times['train_s']:.2f} s, {times['step_ms']:.2f} ms a "
                    f"step between log points, align {align_s:.2f} s; "
                    f"{len(recs)} records and TextGrids, frames conserved "
                    f"on {exact}; no plain version reached; kernel "
                    f"launches {run}")
        corpus, ckpt, out, recs = outs["ota"]
        sub_out = os.path.join(root, "subprocess.jsonl")
        cmd = [sys.executable, "-m", "aligner_tpu_torch", "align", corpus,
               "--checkpoint-dir", ckpt, "--output", sub_out, "--device",
               "cuda"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        if proc.returncode != 0 or read_records(sub_out) != recs:
            raise AssertionError(f"{' '.join(cmd[1:4])} exited "
                                 f"{proc.returncode} or wrote other records:"
                                 f"\n{proc.stdout}{proc.stderr}")
        log(20, f"python -m aligner_tpu_torch align --device cuda as a "
                f"subprocess in {time.perf_counter() - t0:.1f} s: the same "
                f"{len(recs)} records as in process")
        for name, (corpus, _, out, _) in outs.items():
            log(20, f"score_wav {name}: {json.dumps(score(corpus, out))}")
    log(20, f"phase in {time.perf_counter() - t_phase:.1f} s; kernel "
            f"launches {launches}")
    return launches

BF16_STEPS = 10                           # steps of each bf16 training run
BF16_ULPS = 2                             # as tests/test_torch_bf16.py
# log_attn, card vs CPU from the same bf16 encodings: float32 sums of
# |q|^2, q.k and |k|^2 of a few hundred each (an ulp of 3e-5) times the
# temperature, and a log-softmax.
BF16_REST_ATOL = 1e-3


def bf16_ulp(x):
    """The spacing of bfloat16 values at magnitude x (8 bits)."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def bf16_train(phase, name, config, batches, dev, **kwargs):
    """train_aligner for BF16_STEPS steps with every plain version refused;
    returns (model, state, launches). Checks that the loss falls and that
    the parameters stay float32."""
    import aligner_tpu_torch as at
    from aligner_tpu_torch.train.loop import train_aligner
    model = at.OTAAligner(config, device=dev)
    torch.cuda.synchronize()
    at.reset_kernel_launches()
    with plain_versions_refused():
        state, history = train_aligner(
            model, batches, steps=BF16_STEPS, device=dev, learning_rate=LR,
            bin_start=BIN_START, bin_ramp=BIN_RAMP, log_every=1,
            log_fn=lambda line: None, **kwargs)
        torch.cuda.synchronize()
    launches = at.kernel_launches()
    train = [r for r in history if "loss" in r]
    for rec in history:
        if not all(np.isfinite(v) for v in rec.values()):
            raise AssertionError(f"{name}: a metric is not finite: {rec}")
    if len(train) != BF16_STEPS or not train[-1]["loss"] < train[0]["loss"]:
        raise AssertionError(f"{name}: loss did not fall over "
                             f"{len(train)} steps: {train[0]['loss']} -> "
                             f"{train[-1]['loss']}")
    bad = [k for k, p in model.named_parameters() if p.dtype != torch.float32]
    if bad:
        raise AssertionError(f"{name}: parameters not float32: {bad}")
    log(phase, f"{name}: train_aligner {BF16_STEPS} steps, loss "
               f"{train[0]['loss']:.4f} -> {train[-1]['loss']:.4f}, every "
               f"parameter float32, no plain version reached; kernel "
               f"launches {launches}")
    return model, state, launches


def bf16_forward_checks(phase, name, model, batch, skip):
    """On one batch: log_attn float32 and the hard path one state a live
    frame, none on padding."""
    with torch.no_grad():
        out = model(batch["tokens"], batch["mel"], batch["text_lengths"],
                    batch["mel_lengths"])
    if out["log_attn"].dtype != torch.float32 or \
            out["logp_with_prior"].dtype != torch.float32:
        raise AssertionError(f"{name}: lattice dtype "
                             f"{out['log_attn'].dtype}")
    per_frame = out["hard_path"].sum(-1)
    T_y = per_frame.shape[1]
    live = (torch.arange(T_y, device=per_frame.device)[None, :]
            < batch["mel_lengths"][:, None]).float()
    if not torch.equal(per_frame, live):
        raise AssertionError(f"{name}: the hard path does not cover each "
                             "live frame once")
    log(phase, f"{name}: log_attn and logp_with_prior float32, the hard "
               f"path ({'H4' if skip else 'H1'}) one state on each live "
               f"frame of {tuple(batch['mel'].shape[:2])}")
    return out


def bf16_card_vs_cpu(phase, model, config, batch):
    """The bf16 forward on the card against a CPU copy of the same model.
    The encoders are held within BF16_ULPS bfloat16 ulps of their largest
    magnitude, the tolerance of tests/test_torch_bf16.py. Past them the
    forward is float32, so the CPU copy is run again on the card's encoder
    outputs and its log_attn held within BF16_REST_ATOL of the card's on
    live tokens. The end-to-end log_attn difference (an encoder ulp through
    -temperature * |q - k|^2 at dim 192 is about 10x the CPU test's, whose
    dim is 16) and the items whose hard paths differ are reported, not
    gated: a one-ulp lattice difference can flip a near tie."""
    import aligner_tpu_torch as at
    from aligner_tpu_torch.utils.masks import sequence_mask
    cpu_model = at.OTAAligner(config, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    args = ("tokens", "mel", "text_lengths", "mel_lengths")
    errs, card_enc = {}, {}
    with torch.no_grad():
        for which, x, lengths in (("text", "tokens", "text_lengths"),
                                  ("mel", "mel", "mel_lengths")):
            outs = []
            for m, b in ((model, batch), (cpu_model, cpu_batch)):
                mask = sequence_mask(b[lengths], b[x].shape[1])
                enc = getattr(m, f"{which}_encoder")(b[x], mask)
                if enc.dtype != torch.bfloat16:
                    raise AssertionError(f"{which} encoder gave {enc.dtype}")
                outs.append(enc.cpu())
            card, cpu = outs
            card_enc[which] = card
            err = (card.float() - cpu.float()).abs().max().item()
            limit = BF16_ULPS * bf16_ulp(cpu.float().abs().max().item())
            if not err <= limit:
                raise AssertionError(f"bf16 {which} encoder: card vs CPU "
                                     f"{err} > {limit}")
            errs[which] = (err, limit)
        card = model(*(batch[k] for k in args))
        cpu = cpu_model(*(cpu_batch[k] for k in args))
        for which in card_enc:                  # the card's encoder outputs
            getattr(cpu_model, f"{which}_encoder").forward = (
                lambda *a, out=card_enc[which]: out)
        rest = cpu_model(*(cpu_batch[k] for k in args))
    # Padded tokens sit at -1e9 less the log-normaliser, where a float32
    # ulp is 64: compare the live tokens, and require both masked there.
    card_la = card["log_attn"].cpu()
    live = card_la > -1e8
    diffs = {}
    for name, other in (("end to end", cpu), ("on the card's encodings",
                                              rest)):
        if not torch.equal(live, other["log_attn"] > -1e8):
            raise AssertionError("bf16 log_attn: card and CPU mask other "
                                 "cells")
        diffs[name] = ((card_la - other["log_attn"])[live].abs().max()
                       .item(), int((card["hard_path"].cpu()
                                     != other["hard_path"]).flatten(1)
                                    .any(1).sum()))
    if not diffs["on the card's encodings"][0] <= BF16_REST_ATOL:
        raise AssertionError(f"bf16 log_attn card vs CPU on the card's "
                             f"encodings {diffs}")
    log(phase, f"bf16 forward, card against a CPU copy at "
               f"{tuple(batch['mel'].shape[:2])}: text encoder max abs err "
               f"{errs['text'][0]:.4g} (limit {errs['text'][1]:.4g}), mel "
               f"encoder {errs['mel'][0]:.4g} (limit {errs['mel'][1]:.4g}); "
               f"log_attn on live tokens, max abs err and items whose hard "
               f"paths differ, of {len(batch['tokens'])}: " + "; ".join(
                   f"{name} {err:.4g}, {n}" for name, (err, n)
                   in diffs.items())
               + f" (gated at {BF16_REST_ATOL} on the card's encodings)")


def config5_batch(dev):
    """BASELINE.json config 5 (B=64, T_mel=2048) from a seed."""
    rng = np.random.default_rng(9)
    text_lengths = rng.integers(T_X // 2, T_X + 1, B_LONG)
    batch = {
        "tokens": torch.from_numpy(rng.integers(1, VOCAB, (B_LONG, T_X))),
        "mel": torch.from_numpy(rng.standard_normal(
            (B_LONG, T_Y_LONG, N_MELS)).astype(np.float32)),
        "text_lengths": torch.from_numpy(text_lengths),
        "mel_lengths": torch.from_numpy(np.maximum(text_lengths, rng.integers(
            T_Y_LONG // 2, T_Y_LONG + 1, B_LONG)))}
    batch["mel_lengths"][0] = T_Y_LONG
    return {k: v.to(dev) for k, v in batch.items()}


def phase_bf16(dev, float32_steps):
    """The bf16 OTA train step at the CLI width with every plain version
    refused: pause-blind at B=16 (phase 9's batches) and config 5, and
    pause-aware at B=16 (phase 13's); loss, dtypes, the hard path, launch
    counts, step times and profiles beside the float32 steps of this run
    (phases 9 and 13, passed in), and the card's bf16 forward against the
    CPU's. Returns the launches
    of the training runs."""
    import aligner_tpu_torch as at
    from aligner_tpu_torch.train import create_train_state, make_train_step
    t_phase = time.perf_counter()
    common = dict(vocab_size=VOCAB, n_mels=N_MELS, dim=DIM, hidden=HIDDEN,
                  use_recon=True, compute_dtype="bfloat16")
    launches = {}

    def add(run):
        for k, v in run.items():
            launches[k] = launches.get(k, 0) + v

    config = at.OTAConfig(**common)
    batches, _ = train_batches()
    model, state, run = bf16_train(21, f"bf16 pause-blind B={B_OTA}", config,
                                   batches, dev)
    require_launches("bf16 training", run, BF16_STEPS)
    add(run)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batches[0].items()}
    bf16_forward_checks(21, "bf16 pause-blind", model, batch, skip=False)
    bf16_card_vs_cpu(21, model, config, batch)
    step = make_train_step(model, bin_start=0, bin_ramp=1)
    with plain_versions_refused():
        ms = step_ms(step, state, batch, 10)
        wall, busy = profile_step(21, f"bf16 pause-blind B={B_OTA}", step,
                                  state, batch)
    f32_ms, (f32_wall, f32_busy) = float32_steps["pause-blind"]
    log(21, f"step B={B_OTA} {tuple(batch['mel'].shape[:2])}: bf16 "
            f"{ms:.2f} ms synchronised (median of 10), back to back "
            f"{wall:.4f} ms, device busy {busy:.4f} ms; float32 (phase 9) "
            f"{f32_ms:.2f} ms, {f32_wall:.4f} ms, {f32_busy:.4f} ms")

    pause_config = at.OTAConfig(**common, model_pauses=True)
    pause_batch_list = pause_batches()
    anneal = BF16_STEPS // 2

    def curriculum(step_no):                     # -3 -> 0, as phase 13
        return {"pause_bias": -3.0 + 3.0 * min(step_no / anneal, 1.0)}

    pmodel, pstate, run = bf16_train(
        21, f"bf16 pause-aware B={B_OTA}", pause_config, pause_batch_list,
        dev, apply_extra=curriculum)
    require_launches("bf16 pause training", run, BF16_STEPS, SKIP_KERNELS)
    add(run)
    pbatch = {k: torch.as_tensor(v).to(dev)
              for k, v in pause_batch_list[0].items()}
    bf16_forward_checks(21, "bf16 pause-aware", pmodel, pbatch, skip=True)
    step = make_train_step(pmodel, bin_start=0, bin_ramp=1,
                           apply_extra=curriculum)
    with plain_versions_refused():
        ms = step_ms(step, pstate, pbatch, 10)
        wall, busy = profile_step(21, f"bf16 pause B={B_OTA}", step, pstate,
                                  pbatch)
    f32_ms, (f32_wall, f32_busy) = float32_steps["pause"]
    log(21, f"pause step B={B_OTA} {tuple(pbatch['mel'].shape[:2])}: bf16 "
            f"{ms:.2f} ms synchronised (median of 10), back to back "
            f"{wall:.4f} ms, device busy {busy:.4f} ms; float32 (phase 13) "
            f"{f32_ms:.2f} ms, {f32_wall:.4f} ms, {f32_busy:.4f} ms")
    del pmodel, pstate, model, state

    long_model = at.OTAAligner(config, device=dev)
    long_state = create_train_state(long_model, learning_rate=LR)
    long_batch = config5_batch(dev)
    step = make_train_step(long_model, bin_start=0, bin_ramp=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    at.reset_kernel_launches()
    with plain_versions_refused():
        ms = step_ms(step, long_state, long_batch, 3)
        wall, busy = profile_step(21, f"bfloat16 config 5 (B={B_LONG} x "
                                      f"{T_Y_LONG})", step, long_state,
                                  long_batch, reps=3)
    run = at.kernel_launches()
    require_launches("bfloat16 config-5 step", run, 3)
    add(run)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    f32_ms, f32_wall, f32_busy, f32_peak = float32_steps["config 5"]
    log(21, f"config 5 (B={B_LONG} x {T_Y_LONG}, 3 steps): bfloat16 "
            f"{ms:.2f} ms synchronised (median), back to back {wall:.4f} ms, "
            f"device busy {busy:.4f} ms, peak {peak:.2f} GiB; float32 "
            f"(phase 9) {f32_ms:.2f} ms, {f32_wall:.4f} ms, {f32_busy:.4f} "
            f"ms, peak {f32_peak:.2f} GiB")
    log(21, f"phase in {time.perf_counter() - t_phase:.1f} s; kernel "
            f"launches of the bf16 steps {launches}")
    return launches


def phase_cpp_oracle(dev):
    """maximum_path(implementation="cpp") on CUDA tensors against H1 at
    B=32 128x1024 and at B=1 64x256 (BASELINE.json config 1), and both
    routes' walls at B=1 by the host clock (median of 50, synchronised).
    Nothing is routed on the strength of these times."""
    import aligner_tpu_torch as at
    from aligner_tpu_torch.utils.masks import lattice_mask
    walls = {}
    for seed, (B, T_x, T_y) in ((0, (B_MAS, T_X, T_Y)), (1, (1, 64, 256))):
        value, t_x, t_y = ragged(seed, B, T_x, T_y)
        v, tx, ty = (torch.from_numpy(a).to(dev) for a in (value, t_x, t_y))
        mask = lattice_mask(tx, ty, T_x, T_y)
        at.reset_kernel_launches()
        host = at.maximum_path(v, mask, implementation="cpp")
        if at.kernel_launches():
            raise AssertionError(f"the cpp route launched "
                                 f"{at.kernel_launches()}")
        auto = at.maximum_path(v, mask)
        torch.cuda.synchronize()
        if at.kernel_launches() != {"mas_kernel": 1}:
            raise AssertionError(f"auto launched {at.kernel_launches()}")
        if host.device != v.device or host.dtype != v.dtype:
            raise AssertionError(f"cpp gave {host.dtype} on {host.device}")
        require_equal(f"cpp vs H1, B={B} {T_x}x{T_y}", host, auto)
        log(22, f"maximum_path(implementation='cpp') on CUDA tensors, B={B} "
                f"{T_x}x{T_y}: equal to H1's path ('auto', one mas_kernel "
                f"launch; cpp none)")
        if B == 1:
            for name, impl in (("cpp", "cpp"), ("H1", "auto")):
                walls[name] = wall_ms(lambda impl=impl: at.maximum_path(
                    v, mask, implementation=impl), 50)
            h1_device = measure_device_time(
                lambda: at.maximum_path(v, mask), iters=50,
                name_prefix="mas_kernel") * 1e3
    log(22, f"maximum_path at B=1 64x256 (host clock, synchronised, median "
            f"of 50): cpp {walls['cpp']:.4f} ms, H1 ('auto') "
            f"{walls['H1']:.4f} ms (H1's device time in it {h1_device:.4f} "
            f"ms); no route is chosen from these")


def load_example(name):
    import importlib.util
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(here, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_examples_and_conformance(dev):
    """Both examples with --device cuda at their default sizes, then both
    conformance sweeps with one seed and every plain version refused to
    the kernels' wrappers (the sweeps' references are bound at import)."""
    from aligner_tpu_torch import conformance, conformance_losses
    for name in ("batch_serving_torch", "vits_style_integration_torch"):
        t0 = time.perf_counter()
        rc = load_example(name).main(["--device", dev.type])
        if rc != 0:
            raise AssertionError(f"examples/{name}.py returned {rc}")
        log(23, f"examples/{name}.py --device {dev.type} in "
                f"{time.perf_counter() - t0:.1f} s")
    for module in (conformance, conformance_losses):
        t0 = time.perf_counter()
        lines = []
        try:
            with plain_versions_refused():
                cases = module.sweep(1, dev, None, out=lines.append)
                torch.cuda.synchronize()
        except AssertionError:
            for line in lines[-5:]:
                log(23, line)
            raise
        skipped = [line for line in lines if line.startswith("SKIP")]
        log(23, f"{module.__name__} --seeds 1: all {cases} cases conform "
                f"({len(skipped)} route-shape pairs a plan cannot take "
                f"skipped), every plan reached, no plain version reached by "
                f"a wrapper, in {time.perf_counter() - t0:.1f} s; "
                f"{lines[-1]}")

PARALLEL_STEPS = 4
PARALLEL_RTOL, PARALLEL_ATOL = 2e-4, 1e-5   # tests/test_ota_train.py's


def pause_curriculum(step_no):
    """-3 -> 0 over half of TRAIN_STEPS, as phase 13 and demo-pauses."""
    return {"pause_bias": -3.0 + 3.0 * min(step_no / (TRAIN_STEPS // 2),
                                           1.0)}


def parallel_families():
    """Phase 24's three families at the CLI width: (name, model class,
    config, batches, step keywords, the kernels the step launches)."""
    import aligner_tpu_torch as at
    width = dict(vocab_size=VOCAB, n_mels=N_MELS, dim=DIM, hidden=HIDDEN,
                 use_recon=True)
    batches, _ = train_batches()
    return [
        ("OTA", at.OTAAligner, at.OTAConfig(**width), batches,
         dict(bin_start=0, bin_ramp=1), TOKEN_KERNELS),
        ("pause OTA", at.OTAAligner,
         at.OTAConfig(**width, model_pauses=True, pause_silence_anchor=0.5),
         pause_batches(), dict(bin_start=0, bin_ramp=1,
                               apply_extra=pause_curriculum), SKIP_KERNELS),
        ("MoBo", at.MoBoAligner, at.MoBoConfig(**width,
                                               max_duration=D_MOBO),
         batches, dict(objective=mobo_objective, apply_extra=no_hard_decode),
         CLUSTER_KERNELS),
    ]


def require_losses_close(name, got, want):
    if not np.allclose(got, want, rtol=PARALLEL_RTOL, atol=PARALLEL_ATOL):
        raise AssertionError(f"{name}: sharded losses {got} vs unsharded "
                             f"{want}")


def max_param_diff(a, b):
    want = b.state_dict()
    return max(float((v - want[k]).abs().max())
               for k, v in a.state_dict().items())


def parallel_steps(dev, mesh, launches):
    """Each family's sharded steps against the unsharded step from the
    same init; returns the sharded and unsharded OTA step walls."""
    import aligner_tpu_torch as at
    from aligner_tpu_torch.train import create_train_state, make_train_step
    walls = None
    for name, cls, config, batches, kw, kernels in parallel_families():
        # sharded, unsharded, and unsharded again: the card's own spread
        models = [cls(config, device=dev,
                      generator=torch.Generator().manual_seed(0))
                  for _ in range(3)]
        states = [create_train_state(models[0], learning_rate=LR, mesh=mesh),
                  *(create_train_state(m, learning_rate=LR)
                    for m in models[1:])]
        steps = [make_train_step(models[0], mesh, **kw),
                 *(make_train_step(m, **kw) for m in models[1:])]
        on_card = [{k: torch.as_tensor(v).to(dev) for k, v in b.items()}
                   for b in batches[:PARALLEL_STEPS]]
        losses = [[], [], []]
        with plain_versions_refused():
            torch.cuda.synchronize()
            at.reset_kernel_launches()
            for i in range(PARALLEL_STEPS):
                # the sharded step takes the global numpy batch
                _, m = steps[0](states[0], batches[i % len(batches)])
                losses[0].append(float(m["loss"]))
            torch.cuda.synchronize()
            ran = at.kernel_launches()
            for j in (1, 2):
                for i in range(PARALLEL_STEPS):
                    _, m = steps[j](states[j], on_card[i % len(on_card)])
                    losses[j].append(float(m["loss"]))
        require_launches(f"24 {name} sharded steps", ran, PARALLEL_STEPS,
                         kernels)
        for k, v in ran.items():
            launches[k] = launches.get(k, 0) + v
        require_losses_close(name, losses[0], losses[1])
        log(24, f"{name} at {VOCAB}/{N_MELS}/{DIM}/{HIDDEN} f32, B={B_OTA}: "
                f"{PARALLEL_STEPS} sharded steps (mesh 1x1, DDP over "
                f"{torch.distributed.get_backend()}) "
                f"losses {losses[0]} vs unsharded {losses[1]} within rtol "
                f"{PARALLEL_RTOL} / atol {PARALLEL_ATOL}; largest parameter "
                f"difference {max_param_diff(*models[:2]):.3g} (two "
                f"unsharded runs: {max_param_diff(*models[1:]):.3g}, losses "
                f"{losses[2]}); launches {ran}")
        if walls is None:
            with plain_versions_refused():
                walls = parallel_overhead(name, steps[:2], states[:2],
                                          on_card[0])
    return walls


def step_ops(step, state, batch, reps):
    """Per step of `reps` profiled steps: {key: (device ms, count)} of the
    device operations and {key: (self host ms, count)} of the host
    operators."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step(state, batch)
        torch.cuda.synchronize()
    device, host = {}, {}
    for e in prof.key_averages():
        if e.is_user_annotation:
            continue
        if e.device_type == DeviceType.CUDA:
            device[e.key] = (e.self_device_time_total / 1e3 / reps,
                             e.count / reps)
        else:
            host[e.key] = (e.self_cpu_time_total / 1e3 / reps,
                           e.count / reps)
    return device, host


def added_ops(sharded, unsharded, top=8):
    """The operations the sharded step runs more often than the unsharded
    one, largest added time first, as text; and the added time."""
    added = sorted(((ms - unsharded.get(k, (0.0, 0))[0],
                     count - unsharded.get(k, (0.0, 0))[1], k)
                    for k, (ms, count) in sharded.items()
                    if count > unsharded.get(k, (0.0, 0))[1]), reverse=True)
    text = "; ".join(f"{k[:48]} +{ms:.4f} ms +{count:g}"
                     for ms, count, k in added[:top])
    return text, sum(ms for ms, _, _ in added)


def parallel_overhead(name, steps, states, batch, reps=10):
    """The sharded and unsharded steps' walls (median of `reps`, in the
    order sharded, unsharded, unsharded, sharded: each the mean of its
    two), then both under the profiler: the device busy time and the
    operations the sharded step adds, on the device and on the host."""
    order = (0, 1, 1, 0)
    runs = [step_ms(steps[i], states[i], batch, reps) for i in order]
    walls = tuple(statistics.mean(w for i, w in zip(order, runs) if i == j)
                  for j in (0, 1))
    ops = [step_ops(steps[i], states[i], batch, 5) for i in (0, 1)]
    busy = [sum(ms for ms, _ in o[0].values()) for o in ops]
    if not min(busy) > 0:
        raise AssertionError(f"{name}: the profiler saw no device time")
    n_ops = [sum(c for _, c in o[0].values()) for o in ops]
    device_added, device_ms = added_ops(ops[0][0], ops[1][0])
    host_added, host_ms = added_ops(ops[0][1], ops[1][1])
    log(24, f"{name} step walls (host clock, median of {reps}, order "
            f"sharded/unsharded/unsharded/sharded: {runs}): sharded "
            f"{walls[0]:.4f} ms, unsharded {walls[1]:.4f} ms; profiled over "
            f"5 steps: device busy {busy[0]:.4f} ms in {n_ops[0]:g} "
            f"operations against {busy[1]:.4f} ms in {n_ops[1]:g}; device "
            f"operations added by the sharded step ({device_ms:.4f} ms): "
            f"{device_added}; host operators added ({host_ms:.4f} ms self "
            f"time): {host_added}")
    return walls


def parallel_loop(dev, mesh, launches):
    """train_aligner(mesh=) with a checkpoint, restored into an unsharded
    model: its next step equals the sharded run's."""
    import aligner_tpu_torch as at
    from aligner_tpu_torch.train import (create_train_state,
                                         make_train_step,
                                         restore_checkpoint)
    from aligner_tpu_torch.train.loop import train_aligner
    config = at.OTAConfig(vocab_size=VOCAB, n_mels=N_MELS, dim=DIM,
                          hidden=HIDDEN, use_recon=True)
    batches, _ = train_batches()
    model = at.OTAAligner(config, device=dev)
    with plain_versions_refused(), tempfile.TemporaryDirectory() as ckpt:
        torch.cuda.synchronize()
        at.reset_kernel_launches()
        state, history = train_aligner(
            model, batches, steps=TRAIN_STEPS, device=dev, learning_rate=LR,
            mesh=mesh, bin_start=BIN_START, bin_ramp=BIN_RAMP, log_every=1,
            checkpoint_dir=ckpt, log_fn=lambda line: None)
        torch.cuda.synchronize()
        ran = at.kernel_launches()
        fresh = at.OTAAligner(config, device=dev,
                              generator=torch.Generator().manual_seed(1))
        restored = restore_checkpoint(ckpt, create_train_state(
            fresh, learning_rate=LR))
        kw = dict(bin_start=BIN_START, bin_ramp=BIN_RAMP)
        _, sharded = make_train_step(model, mesh, **kw)(state, batches[0])
        first = {k: torch.as_tensor(v).to(dev) for k, v in batches[0].items()}
        _, plain = make_train_step(fresh, **kw)(restored, first)
    require_launches("24 train_aligner(mesh=)", ran, TRAIN_STEPS)
    for k, v in ran.items():
        launches[k] = launches.get(k, 0) + v
    losses = [history[0]["loss"], history[-1]["loss"]]
    if not losses[1] < losses[0]:
        raise AssertionError(f"train_aligner(mesh=): the loss went from "
                             f"{losses[0]} to {losses[1]}")
    require_losses_close("the step after the checkpoint",
                         [float(sharded["loss"])], [float(plain["loss"])])
    log(24, f"train_aligner(mesh=) {TRAIN_STEPS} steps, loss {losses[0]:.4f}"
            f" -> {losses[1]:.4f}, launches {ran}; its checkpoint restored "
            f"into an unsharded model, whose next step's loss "
            f"{float(plain['loss']):.6f} equals the sharded run's "
            f"{float(sharded['loss']):.6f}; largest parameter difference "
            f"after it {max_param_diff(model, fresh):.3g}")


def parallel_sequence(dev, mesh):
    """mas_sequence_parallel, gated and pipelined, against H1."""
    from aligner_tpu_torch.ops.mas_kernel import mas_path
    from aligner_tpu_torch.parallel import mas_sequence_parallel
    value, t_x, t_y = ragged(24, B_MAS, T_X, T_Y)
    v = torch.from_numpy(value).to(dev)
    tx, ty = (torch.from_numpy(a).to(dev) for a in (t_x, t_y))
    want = mas_path(v, tx, ty)
    for microbatch in (None, 2):
        t0 = time.perf_counter()
        got = mas_sequence_parallel(v, tx, ty, mesh, microbatch=microbatch)
        torch.cuda.synchronize()
        require_equal(f"mas_sequence_parallel microbatch={microbatch}", got,
                      want)
        log(24, f"mas_sequence_parallel B={B_MAS} {T_X}x{T_Y} microbatch="
                f"{microbatch}: bit-identical to mas_path (H1) in "
                f"{time.perf_counter() - t0:.3f} s (its block sweeps are "
                f"plain PyTorch, as the JAX function's are lax scans)")


def parallel_graft(dev, launches):
    """The graft twin's forward on the card (H1, H2) against the CPU's
    plain route."""
    import aligner_tpu_torch as at
    from aligner_tpu_torch.graft_entry import entry
    fn, args = entry(dev)
    with plain_versions_refused():
        torch.cuda.synchronize()
        at.reset_kernel_launches()
        got = fn(*args)
        torch.cuda.synchronize()
        ran = at.kernel_launches()
    require_launches("24 graft entry", ran, 1,
                     ("mas_kernel", "forward_sum_alpha_kernel"))
    for k, v in ran.items():
        launches[k] = launches.get(k, 0) + v
    params, *inputs = args
    want = fn({k: p.cpu() for k, p in params.items()},
              *(a.cpu() for a in inputs))
    for name, g, w in zip(("loss_forward_sum", "loss_bin"), got, want):
        if not torch.allclose(g.cpu(), w, rtol=FS_RTOL, atol=0):
            raise AssertionError(f"graft entry {name} {g.item()} vs the "
                                 f"CPU's {w.item()}")
    require_equal("graft entry durations", got[2].cpu(), want[2])
    log(24, f"graft entry fn (OTA forward, B=8 64x256, vocab 100, dim 96) "
            f"on the card: losses {got[0].item():.6f}, {got[1].item():.6f} "
            f"within rtol {FS_RTOL} of the CPU plain route's "
            f"{want[0].item():.6f}, {want[1].item():.6f}, durations "
            f"equal; launches {ran}")


def phase_parallel(dev):
    """The parallel path at world size 1 (one card): a 1x1 mesh over NCCL
    from a file store, the sharded train steps of three families against
    the unsharded ones, train_aligner(mesh=) with a checkpoint restored
    unsharded, sequence-parallel MAS and the graft twin's forward, every
    plain version refused; returns the kernel launches of its runs."""
    from aligner_tpu_torch._build import card_label
    from aligner_tpu_torch.parallel import make_mesh
    from aligner_tpu_torch.parallel.mesh import init_process_group
    launches = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        init_process_group(os.path.join(tmp, "store"), 0, 1, dev.type)
        try:
            mesh = make_mesh(1, 1, device_type=dev.type)
            walls = parallel_steps(dev, mesh, launches)
            parallel_loop(dev, mesh, launches)
            with plain_versions_refused():
                parallel_sequence(dev, mesh)
            parallel_graft(dev, launches)
        finally:
            torch.distributed.destroy_process_group()
    log(24, f"step walls at B={B_OTA} (host clock, median of 10, card "
            f"{card_label(0)}): sharded (1x1 mesh, DDP) {walls[0]:.4f} ms, "
            f"unsharded {walls[1]:.4f} ms; phase 24 took "
            f"{time.perf_counter() - t0:.1f} s; launches {launches}")
    return launches


CAMPAIGN_STEPS, CAMPAIGN_UTTERANCES = 30, 16
WAV_LINE_KEYS = {"group", "run", "seed", "n", "boundary_f1_tol2",
                 "duration_exact", "duration_mae", "device", "jax",
                 "f1_diff"}
DECAY_LR, DECAY_WD = 1e-3, 0.1


def captured_lines(fn, *args):
    """The lines `fn(*args)` prints to standard output."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue().splitlines()


def require_line(name, line, keys):
    missing = keys - set(line)
    if missing:
        raise AssertionError(f"{name}: no {sorted(missing)} in {line}")


def campaign_wav_rows(dev, root, label):
    """round5's hop128_s0 through wav_rows' command line (then again: its
    resume trains nothing) and wav_pauses' seed-0 pause-aware row through
    its runner; returns both lines."""
    from aligner_tpu_torch import wav_rows
    out = os.path.join(root, "wav_rows.jsonl")
    argv = ["--rows", "hop128_s0", "--steps", str(CAMPAIGN_STEPS),
            "--utterances", str(CAMPAIGN_UTTERANCES), "--device", str(dev),
            "--out", out]
    wav_rows.main(argv)
    t0 = time.perf_counter()
    wav_rows.main(argv)
    resume_s = time.perf_counter() - t0
    lines = read_records(out)
    pause = next(r for r in wav_rows.ROWS
                 if r.key == ("wav_pauses", "wav_pauses_pauseaware", 0))
    runner = wav_rows.Runner(root, CAMPAIGN_STEPS, CAMPAIGN_UTTERANCES,
                             str(dev))
    lines.append(wav_rows.line_of(runner.run(pause),
                                  wav_rows.jax_row(pause), label))
    if len(lines) != 2:
        raise AssertionError(f"wav_rows wrote {len(lines)} lines, resume "
                             f"included; expected 1 and the pause row")
    for line, extra in zip(lines, ({"truth_scale", "tolerance"},
                                   {"pause_precision", "pause_recall"})):
        require_line(f"wav_rows {line['run']}", line, WAV_LINE_KEYS | extra)
        if line["n"] != CAMPAIGN_UTTERANCES or line["steps"] != \
                CAMPAIGN_STEPS or line["device"] != label or \
                "boundary_f1_tol2" not in line["jax"]:
            raise AssertionError(f"wav_rows line {line}")
        log(25, f"wav_rows {line['group']} {line['run']} s{line['seed']}: "
                f"F1@2 {line['boundary_f1_tol2']} (JAX at 6000 steps "
                f"{line['jax']['boundary_f1_tol2']}), {line['steps']} steps "
                f"in {line['train_s']:.2f} s")
    log(25, f"wav_rows resume with the row in --out: {resume_s:.2f} s, no "
            f"line written")
    return lines


def campaign_demo_row(dev):
    """demo_rows' row 2 (demo-romo) at CAMPAIGN_STEPS as a subprocess."""
    from aligner_tpu_torch import demo_rows
    (line,) = [json.loads(x) for x in captured_lines(
        demo_rows.main, ["--rows", "2", "--steps", str(CAMPAIGN_STEPS),
                         "--device", dev.type])]
    require_line("demo_rows", line, {"run", "seed", "steps", "result", "jax",
                                     "f1", "jax_f1", "f1_diff",
                                     "jax_seed_range", "wall_s", "device"})
    if line["steps"] != CAMPAIGN_STEPS or line["result"].get("demo") != \
            "romo" or line["jax"].get("demo") != "romo":
        raise AssertionError(f"demo_rows line {line}")
    log(25, f"demo_rows {line['run']!r} at {line['steps']} steps in "
            f"{line['wall_s']:.1f} s: F1@2 {line['f1']} (JAX at 600 steps "
            f"{line['jax_f1']}, seed range {line['jax_seed_range']})")


def campaign_swap_probe(dev):
    """pause_swap_probe --hard at CAMPAIGN_STEPS: its lever grid and swap
    count."""
    from aligner_tpu_torch import pause_swap_probe
    lines = captured_lines(pause_swap_probe.main,
                           ["--steps", str(CAMPAIGN_STEPS), "--hard",
                            "--device", str(dev)])
    rec = json.loads(lines[-1])
    require_line("pause_swap_probe", rec, {"grid", "n_swaps",
                                           "lattice_prefers_swap", "swaps",
                                           "device"})
    if len(rec["grid"]) != 12 or not all(
            np.isfinite(g["f1_tol2"]) for g in rec["grid"]) or \
            not any(line.startswith("| +0.0 | 1 |") for line in lines):
        raise AssertionError(f"pause_swap_probe printed {lines}")
    log(25, f"pause_swap_probe --hard at {CAMPAIGN_STEPS} steps: "
            f"{rec['n_swaps']} swaps, the lattice prefers the swapped gap "
            f"in {rec['lattice_prefers_swap']}; F1@2 at enter cost 0, "
            f"min_len 1: {rec['grid'][-3]['f1_tol2']:.3f}")


def campaign_weight_decay(dev):
    """A forward-sum-only step at the CLI width: the reconstruction
    decoder takes no gradient, so it decays as under optax's adamw, with
    zero moments."""
    import aligner_tpu_torch as at
    from aligner_tpu_torch.train import create_train_state, make_train_step
    model = at.OTAAligner(at.OTAConfig(vocab_size=VOCAB, n_mels=N_MELS,
                                       dim=DIM, hidden=HIDDEN,
                                       use_recon=True), device=dev)
    decoder = model.mel_decoder.weight.detach().clone()
    state = create_train_state(model, learning_rate=DECAY_LR,
                               weight_decay=DECAY_WD)
    step = make_train_step(model, objective=lambda out, _: (
        out["loss_forward_sum"].mean(), {}))
    step(state, dict(zip(("tokens", "mel", "text_lengths", "mel_lengths"),
                         ota_inputs(dev))))
    moments = state.optimizer.state[model.mel_decoder.weight]
    torch.testing.assert_close(model.mel_decoder.weight,
                               decoder * (1 - DECAY_LR * DECAY_WD),
                               rtol=2 ** -23, atol=0)
    if moments["exp_avg"].abs().max().item() != 0 or \
            moments["exp_avg_sq"].abs().max().item() != 0:
        raise AssertionError("the decoder's Adam moments moved without a "
                             "gradient")
    log(25, f"weight decay without a gradient: the decoder is before * "
            f"(1 - {DECAY_LR} * {DECAY_WD}) after one forward-sum-only step, "
            f"its moments 0, its count {int(moments['step'])}")


def phase_campaigns(dev):
    """Phase 25: the quality campaigns and the swap probe at a smoke size
    on the card, then the weight-decay repair; returns the kernel
    launches of the in-process runs."""
    import aligner_tpu_torch as at
    from aligner_tpu_torch._build import card_label
    t0 = time.perf_counter()
    label = card_label(0)
    with tempfile.TemporaryDirectory() as root:
        torch.cuda.synchronize()
        at.reset_kernel_launches()
        with plain_versions_refused():
            campaign_wav_rows(dev, root, label)
            campaign_swap_probe(dev)
        torch.cuda.synchronize()
        launches = at.kernel_launches()
    require_launches("campaigns", launches, 1, TOKEN_KERNELS + SKIP_KERNELS)
    campaign_demo_row(dev)
    campaign_weight_decay(dev)
    log(25, f"phase 25 took {time.perf_counter() - t0:.1f} s; launches "
            f"{launches}")
    return launches


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
    two_pass_errs = phase_two_pass_kernels(dev)
    # Exact float32 matmuls and convolutions for the comparisons below.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(5, "TF32 off for matmul and cuDNN (float32 throughout)")
    serving, mas_run, ota_run, serving_run = phase_main_path(dev)
    phase_check_main(dev, mas_run, ota_run, serving_run)
    times = phase_times(dev)
    grad_err = phase_grad(dev)
    training, _, blind_step, step64 = phase_train(dev)
    phase_demo(dev)
    skip_mas_err = phase_skip_mas(dev)
    skip_alpha_err, skip_gamma_err = phase_skip_sums(dev)
    pauses, pause_step_ms, pause_profile = phase_pause_path(
        dev, blind_step[0])
    phase_demo_pauses(dev)
    mobo_errs = phase_mobo_kernels(dev)
    mobo = phase_mobo_path(dev)
    phase_demo_mobo(dev)
    two_pass = phase_two_pass_path(dev)
    wav = phase_wav(dev)
    bf16 = phase_bf16(dev, {"pause-blind": blind_step,
                            "pause": (pause_step_ms, pause_profile),
                            "config 5": step64})
    phase_cpp_oracle(dev)
    phase_examples_and_conformance(dev)
    parallel = phase_parallel(dev)
    campaigns = phase_campaigns(dev)
    pallas = "aligner_tpu/ops/"
    kernels = []
    for name, source, replaces, err in [
            ("mas_kernel", "mas.cu", "mas_pallas.py:547", mas_err),
            ("forward_sum_alpha_kernel", "forward_sum.cu",
             "forward_sum_pallas.py:77", fs_err),
            ("forward_sum_grad_kernel", "forward_sum.cu",
             "forward_sum_pallas.py:126", grad_err),
            ("mas_skip_kernel", "skip_dp.cu", "skip_dp_pallas.py:181",
             skip_mas_err),
            ("forward_sum_skip_alpha_kernel", "skip_dp.cu",
             "skip_dp_pallas.py:476", skip_alpha_err),
            ("forward_sum_skip_gamma_kernel", "skip_dp.cu",
             "skip_dp_pallas.py:524", skip_gamma_err),
            ("mobo_alpha_kernel", "mobo.cu", "mobo_pallas.py:57",
             mobo_errs[0]),
            ("mobo_bp_kernel", "mobo.cu", "mobo_pallas.py:84", mobo_errs[1]),
            ("mobo_beta_kernel", "mobo.cu", "mobo_pallas.py:114",
             mobo_errs[2]),
            *((name, "mas_two_pass.cu", f"mas_pallas.py:{line}",
               two_pass_errs[name])
              for name, line in zip(TWO_PASS_KERNELS,
                                    (981, 1139, 1171, 1411, 1603)))]:
        by_path = {"serving": serving.get(name, 0),
                   "training": training.get(name, 0),
                   "pauses": pauses.get(name, 0),
                   "mobo": mobo.get(name, 0),
                   "two_pass": two_pass.get(name, 0),
                   "wav": wav.get(name, 0),
                   "bf16": bf16.get(name, 0),
                   "parallel": parallel.get(name, 0),
                   "campaigns": campaigns.get(name, 0)}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"aligner_tpu_torch/csrc/{source}",
            "replaces": pallas + replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": err, **times[name]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
