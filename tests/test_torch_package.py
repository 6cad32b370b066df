"""aligner_tpu_torch as a package: it never imports jax, it picks a kernel
or its plain version by the tensor's device alone, and on a card its
kernels agree with their plain versions and the main path never touches
a plain version.

This file imports no JAX, so the tests marked `cuda` also run on a GPU
machine that has none (the repo's conftest imports jax, hence
--noconftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_package.py
"""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import aligner_tpu_torch as at
from aligner_tpu_torch.ops import (forward_sum_kernel, mas_kernel, mobo,
                                   mobo_kernel, skip_dp, skip_dp_kernel)
from aligner_tpu_torch.ops.forward_sum import (_masked_logp,
                                               _total_from_alphas,
                                               _valid_items, forward_sum_loss)
from aligner_tpu_torch.train import create_train_state, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


def ragged(seed, B, T_x, T_y):
    rng = np.random.default_rng(seed)
    value = (rng.standard_normal((B, T_x, T_y)) * 3).astype(np.float32)
    t_x = rng.integers(1, T_x + 1, B).astype(np.int32)
    t_y = np.maximum(t_x, rng.integers(1, T_y + 1, B)).astype(np.int32)
    t_x[0], t_y[0] = T_x, T_y // 2         # t_x > t_y: all-zero path
    t_x[-1] = 0
    return value, t_x, t_y


def small_batch():
    rng = np.random.default_rng(0)
    return (torch.from_numpy(rng.integers(0, 20, (3, 9))),
            torch.from_numpy(rng.standard_normal((3, 30, 80))
                             .astype(np.float32)),
            torch.tensor([9, 5, 2]), torch.tensor([30, 17, 6]))


def small_ota(device, **config):
    model = at.OTAAligner(at.OTAConfig(vocab_size=20, dim=16, hidden=32,
                                       use_recon=True, **config),
                          device=device)
    with torch.no_grad():
        return model(*[t.to(device) for t in small_batch()])


MOBO_FAMILIES = (
    (at.MoBoAligner, at.MoBoConfig(vocab_size=20, dim=16, hidden=32,
                                   max_duration=6, use_recon=True)),
    (at.RoMoAligner, at.RoMoConfig(vocab_size=20, dim=16, hidden=32,
                                   max_duration=6, window=8,
                                   use_recon=True)))


def mobo_ragged(seed, B, T_x, T_y, D):
    """Token-major grid [T_x, B, T_y + 1] of feasible ragged items with
    the edge items: t_x = 1; a full item; no boundary sequence
    (t_y > t_x * D); t_x = 0."""
    rng = np.random.default_rng(seed)
    energies = rng.standard_normal((B, T_y, T_x)).astype(np.float32)
    t_x = rng.integers(max(1, -(-T_y // D)), T_x + 1, B).astype(np.int32)
    t_y = np.clip(rng.integers(1, T_y + 1, B), t_x,
                  np.minimum(t_x * D, T_y)).astype(np.int32)
    t_x[:4] = [1, T_x, 2, 0]
    t_y[:4] = [min(D, T_y), T_y, min(2 * D + 3, T_y), T_y // 2]
    return energies, t_x, t_y


def skip_ragged(seed, B, T_x, T_y):
    """State-major lattice [B, 2*T_x+1, T_y] with the contract's edge
    items: t_x > t_y, t_x = 0, t_x = 1, t_x = t_y, and a tie-only item."""
    rng = np.random.default_rng(seed)
    value = rng.standard_normal((B, 2 * T_x + 1, T_y)).astype(np.float32)
    t_x = rng.integers(1, T_x + 1, B).astype(np.int32)
    t_y = np.maximum(t_x, rng.integers(1, T_y + 1, B)).astype(np.int32)
    t_x[0], t_y[0] = T_x, T_x           # every frame a token
    t_x[1], t_y[1] = T_x, T_y           # a full item
    if B > 2:
        t_x[2], t_y[2] = T_x, T_x // 2  # t_x > t_y: all-zero path
        t_x[3] = 0
        t_x[4], t_y[4] = 1, T_y
        value[5] = 0.0                  # ties everywhere
    return value, t_x, t_y


def test_import_pulls_in_no_jax():
    code = ("import importlib, pkgutil, sys\n"
            "import aligner_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'flax', 'optax', 'orbax',\n"
            "              'aligner_tpu'))\n"
            "assert not bad, bad\n"
            "for name in ('train.step', 'train.loop', 'train.checkpoint',\n"
            "             'data.prefetch', 'data.synthetic',\n"
            "             'data.batching', 'utils.eval', 'cli',\n"
            "             'ops.skip_dp', 'ops.skip_dp_kernel',\n"
            "             'ops.skip_dp_reference', 'ops.mobo',\n"
            "             'ops.mobo_kernel', 'models.mobo', 'models.romo',\n"
            "             'models.convert', 'bench_mas', 'ops.mel',\n"
            "             'ops.durations', 'ops.regularizers', 'data.files',\n"
            "             'data.text', 'data.textgrid', 'score_wav',\n"
            "             'native.build', 'utils.profiling', 'conformance',\n"
            "             'conformance_losses'):\n"
            "    assert 'aligner_tpu_torch.' + name in sys.modules, name\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", [
    "chip_smoke.py", "aligner_tpu_torch/bench_mas.py",
    "aligner_tpu_torch/cli.py", "aligner_tpu_torch/_build.py",
    "aligner_tpu_torch/ops/mas_kernel.py",
    "aligner_tpu_torch/ops/__init__.py", "aligner_tpu_torch/ops/mel.py",
    "aligner_tpu_torch/data/files.py", "aligner_tpu_torch/score_wav.py",
    "aligner_tpu_torch/native/build.py",
    "aligner_tpu_torch/utils/profiling.py",
    "aligner_tpu_torch/conformance.py",
    "aligner_tpu_torch/conformance_losses.py",
    "examples/batch_serving_torch.py",
    "examples/vits_style_integration_torch.py"])
def test_source_names_no_jax_import(path):
    """No import statement of the file reaches jax or the JAX package."""
    with open(os.path.join(REPO, path)) as f:
        source = f.read()
    assert not re.search(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|aligner_tpu)\b",
        source, re.MULTILINE)


BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "p50_align_step_ms",
              "config", "timing_method", "route", "device"}
BENCH_ROUTES = ["two_pass", "stage", "split", "chains2", "chains4", "fused"]


def bench_mas(*args):
    return subprocess.run(
        [sys.executable, "-m", "aligner_tpu_torch", "bench-mas", "--batch",
         "4", "--t-text", "8", "--t-mel", "40", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300)


def test_bench_mas_cpu_prints_one_line_per_route():
    """`--route all` on the plain versions: bench.py's keys on every
    line, the default route last, nothing labelled as a card's time. (The
    batch is 4 so that the 4-chain route divides it.)"""
    proc = bench_mas("--device", "cpu", "--route", "all")
    assert proc.returncode == 0, proc.stderr
    recs = [json.loads(line) for line in proc.stdout.strip().splitlines()]
    assert [r["route"] for r in recs] == BENCH_ROUTES
    for rec in recs:
        assert BENCH_KEYS <= set(rec) and "error" not in rec
        assert rec["metric"] == "mas_paths_per_sec_per_chip"
        assert rec["unit"] == "paths/s" and rec["value"] > 0
        assert rec["vs_baseline"] == round(rec["value"] / 2110.0, 2)
        assert rec["config"] == "B=4,T_text=8,T_mel=40,ragged"
        assert rec["timing_method"] == "host_clock"
        assert rec["device"].startswith("cpu")
    one = bench_mas("--device", "cpu", "--route", "split")
    assert one.returncode == 0, one.stderr
    assert json.loads(one.stdout)["route"] == "split"


@pytest.mark.parametrize("args,error", [
    (("--device", "cuda"), "no CUDA device"),
    (("--device", "cpu", "--route", "chains4", "--batch", "6"),
     "must divide the batch")])
def test_bench_mas_failure_is_an_error_line_and_exit_1(args, error):
    """No card under `--device cuda`, or a route the batch cannot take:
    bench.py's error line and exit code 1, never a quiet move to the CPU
    or to another route."""
    if args == ("--device", "cuda") and torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = bench_mas(*args)
    assert proc.returncode == 1
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert error in rec["error"] and rec["value"] == 0.0
    assert rec["metric"] == "mas_paths_per_sec_per_chip"
    assert rec["vs_baseline"] == 0.0 and rec["unit"] == "paths/s"


def test_probe_barriers_without_a_card_is_an_error_line_and_exit_1(
        monkeypatch, capsys):
    """The barrier probe times the card only: with no CUDA device it
    prints an error line and returns 1, building nothing."""
    from aligner_tpu_torch import probe_barriers
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe_barriers.main() == 1
    assert json.loads(capsys.readouterr().out) == {"error": "no CUDA device"}


def test_probe_chain_without_a_card_is_an_error_line_and_exit_1(
        monkeypatch, capsys):
    """The chain probe, likewise: an error line and 1, nothing built."""
    from aligner_tpu_torch import probe_chain
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe_chain.main() == 1
    assert json.loads(capsys.readouterr().out) == {"error": "no CUDA device"}


def test_cpu_route_launches_no_kernel():
    at.reset_kernel_launches()
    value, t_x, t_y = ragged(0, 4, 6, 15)
    mask = ((np.arange(6)[None, :, None] < t_x[:, None, None])
            & (np.arange(15)[None, None, :] < t_y[:, None, None]))
    at.maximum_path(torch.from_numpy(value), torch.from_numpy(mask))
    small_ota("cpu")
    model = at.OTAAligner(at.OTAConfig(vocab_size=20, dim=16, hidden=32))
    make_train_step(model)(create_train_state(model), dict(zip(
        ("tokens", "mel", "text_lengths", "mel_lengths"), small_batch())))
    at.BatchAligner(max_text=6, max_mel=15, max_batch=2, device="cpu") \
        .align_durations([value[1, :3, :7]])
    small_ota("cpu", model_pauses=True)
    at.SkipBatchAligner(max_text=3, max_mel=15, max_batch=2, device="cpu") \
        .align([value[1, :5, :7]])
    for cls, config in MOBO_FAMILIES:
        out = cls(config)(*small_batch())
        (out["loss_recon"] + out.get("loss", out.get("loss_mobo"))).backward()
    v, tx, ty = (torch.from_numpy(a) for a in (value, t_x, t_y))
    for options in TWO_PASS_ROUTES.values():
        mas_kernel.mas_path(v, tx, ty, fuse=False, **options)
    assert at.kernel_launches() == {}


def test_wav_front_end_and_posteriors_on_the_card(cuda):
    """The log-mel on the card (cuFFT) against the CPU's (pocketfft) at
    atol 1e-4, a wav shorter than the centred pad included; and
    alignment_posteriors through H2 and H3 against the plain versions."""
    from aligner_tpu_torch.ops import alignment_posteriors
    from aligner_tpu_torch.ops.mel import MelConfig, log_mel_spectrogram
    rng = np.random.default_rng(0)
    for cfg in (MelConfig(), MelConfig(hop_length=128, n_fft=512,
                                       win_length=512, center=False)):
        for n in (300, 5000, 22050):
            wav = torch.from_numpy(
                (rng.standard_normal((2, n)) * 0.3).astype(np.float32))
            want = log_mel_spectrogram(wav, cfg)
            got = log_mel_spectrogram(wav.to(cuda), cfg)
            assert got.device.type == "cuda" and got.shape == want.shape
            torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
    logits = torch.from_numpy(rng.standard_normal((4, 60, 12))
                              .astype(np.float32))
    lp = torch.log_softmax(logits, -1)
    t_x, t_y = torch.tensor([12, 5, 1, 9]), torch.tensor([60, 33, 7, 9])
    want = alignment_posteriors(lp, t_x, t_y)
    at.reset_kernel_launches()
    got = alignment_posteriors(lp.to(cuda), t_x.to(cuda), t_y.to(cuda))
    assert at.kernel_launches() == {"forward_sum_alpha_kernel": 1,
                                    "forward_sum_grad_kernel": 1}
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("call", ["mas_path", "mas_durations", "mas_bits",
                                  "mas_backtrack", "mas_walk_idx",
                                  "mas_expand",
                                  "forward_sum_alpha", "forward_sum_grad"])
def test_other_devices_raise(call):
    """Neither a kernel nor a plain version runs on a device that is not
    the CPU or CUDA: the route is never guessed."""
    value = torch.zeros((2, 3, 5), device="meta")
    lengths = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        if call == "forward_sum_alpha":          # [T_y, B, T_x]
            forward_sum_kernel.forward_sum_alpha(value, torch.ones(3))
        elif call == "forward_sum_grad":
            forward_sum_kernel.forward_sum_grad(value, value, torch.zeros(3),
                                                torch.ones(3), torch.ones(3))
        elif call in ("mas_backtrack", "mas_walk_idx"):
            getattr(mas_kernel, call)(value.to(torch.uint8), lengths,
                                      lengths)
        elif call == "mas_expand":
            mas_kernel.mas_expand(value[0].to(torch.int32), 4)
        else:
            getattr(mas_kernel, call)(value, lengths, lengths)


@pytest.fixture
def mas_planes(monkeypatch):
    """planes(where) makes H1 keep its bit plane in device memory
    ("global") whatever the shape, with its plan's threads, cells and
    fetch and the device-memory ring for them; "shared" keeps the plan
    (the wide kernel's plane is in device memory either way)."""
    plan = mas_kernel._mas_plan

    def force(where):
        if where == "shared":
            return

        def device_memory_plan(T_x, T_y, frames_contiguous):
            threads, cells, ring, planes, fetch, smem = plan(
                T_x, T_y, frames_contiguous)
            if fetch == "wide":
                return threads, cells, ring, planes, fetch, smem
            ring = next(r for c, r, p, f in mas_kernel.MAS_PLANS
                        if (c, p, f) == (cells, "global", fetch))
            return (threads, cells, ring, "global", fetch,
                    mas_kernel._mas_smem(threads * cells, ring, 0))

        monkeypatch.setattr(mas_kernel, "_mas_plan", device_memory_plan)

    return force


@pytest.fixture
def mas_outputs_prefilled(monkeypatch):
    """Every output that H1, H11 or H13 writes whole starts as garbage:
    paths NaN, durations -1, bits 0xA5, index rows 0x7F7F7F7F; so a cell
    it leaves unwritten shows."""
    path_out = mas_kernel._path_out
    bits_out = mas_kernel._bits_out
    durations_out = mas_kernel._durations_out
    idx_out = mas_kernel._idx_out

    def paths(*args):
        out, view = path_out(*args)
        out.fill_(float("nan"))
        return out, view

    def bits(*args):
        return bits_out(*args).fill_(0xA5)

    monkeypatch.setattr(mas_kernel, "_path_out", paths)
    monkeypatch.setattr(mas_kernel, "_bits_out", bits)
    monkeypatch.setattr(mas_kernel, "_durations_out",
                        lambda *args: durations_out(*args).fill_(-1))
    monkeypatch.setattr(mas_kernel, "_idx_out",
                        lambda *args: idx_out(*args).fill_(0x7F7F7F7F))


# MAS: each shape with the bit plane in shared memory, as planned, and in
# device memory; the natural lattice (frames contiguous: tiles of 8
# frames) and a frame-major view (rows); T_x = 1100 (two cells a thread);
# the long form 128x8192; T_x = 8200 past the widest plan (the wide
# kernel). Item 0 has t_x > t_y, the last t_x = 0.
@pytest.mark.cuda
@pytest.mark.parametrize("planes", ["shared", "global"])
@pytest.mark.parametrize("seed,B,T_x,T_y", [(0, 8, 16, 61), (1, 5, 40, 200),
                                            (2, 2, 1100, 1300),
                                            (3, 3, 128, 8192),
                                            (4, 3, 8200, 8300)])
def test_mas_kernel_matches_plain(cuda, mas_planes, mas_outputs_prefilled,
                                  seed, B, T_x, T_y, planes):
    """Bit-identical paths, durations and frame-major output, every cell
    written over garbage; the forward alone equal to `mas_bits` on the
    CPU on every byte, from either layout; the walk alone equal to the
    plain path, also on bits from elsewhere (bytes of 3, ones at token
    0)."""
    mas_planes(planes)
    value, t_x, t_y = ragged(seed, B, T_x, T_y)
    v, tx, ty = (torch.from_numpy(a).to(cuda) for a in (value, t_x, t_y))
    fm_view = v.transpose(1, 2).contiguous().transpose(1, 2)
    for lattice, contiguous in ((v, True), (fm_view, False)):
        assert mas_kernel._mas_plan(T_x, T_y, contiguous)[3] == (
            "global" if planes == "global" or T_x > 8192 else "shared")
    want = mas_kernel.mas_plain(v, tx, ty)
    path = mas_kernel.mas_path(v, tx, ty)
    torch.testing.assert_close(path, want, rtol=0, atol=0)
    torch.testing.assert_close(mas_kernel.mas_durations(v, tx, ty),
                               want.sum(-1).to(torch.int32), rtol=0, atol=0)
    fm = mas_kernel.mas_path(fm_view, tx, ty, frame_major=True)
    torch.testing.assert_close(fm, want.transpose(1, 2), rtol=0, atol=0)
    bits = mas_kernel.mas_bits(v, tx, ty)
    torch.testing.assert_close(
        bits, mas_kernel.mas_bits(v.cpu(), tx.cpu(), ty.cpu()).to(cuda),
        rtol=0, atol=0)
    assert torch.equal(mas_kernel.mas_bits(fm_view, tx, ty), bits)
    foreign = bits * 3
    foreign[:, :, 0] = 1
    for given in (bits, foreign):
        torch.testing.assert_close(mas_kernel.mas_backtrack(given, tx, ty),
                                   want, rtol=0, atol=0)
        torch.testing.assert_close(
            mas_kernel.mas_backtrack(given, tx, ty, frame_major=True),
            want.transpose(1, 2), rtol=0, atol=0)


TWO_PASS_ROUTES = {"cmp": {}, "stage": {"form": "stage"},
                   "split": {"form": "split"}, "chains2": {"chains": 2},
                   "chains4": {"chains": 4}}


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(TWO_PASS_ROUTES))
@pytest.mark.parametrize("seed,B,T_x,T_y", [(30, 8, 16, 61),
                                            (31, 4, 45, 300),
                                            (32, 4, 1100, 1300)])
def test_two_pass_routes_match_plain(cuda, route, seed, B, T_x, T_y):
    """Every two-pass route bit-identical to mas_plain in both layouts,
    its bits equal to the plain forward's on every cell; the shapes have
    T_x no multiple of 32, T_y no multiple of 128, and T_x > 1024 / chains
    (threads stride over the token rows)."""
    options = TWO_PASS_ROUTES[route]
    value, t_x, t_y = ragged(seed, B, T_x, T_y)
    v, tx, ty = (torch.from_numpy(a).to(cuda) for a in (value, t_x, t_y))
    want = mas_kernel.mas_plain(v, tx, ty)
    chains = options.get("chains", 1)
    bits = mas_kernel.mas_bits(v, tx, ty, chains=chains)
    torch.testing.assert_close(bits, mas_kernel.mas_bits(v.cpu(), tx.cpu(),
                                                         ty.cpu()).to(cuda),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        mas_kernel.mas_backtrack(bits, tx, ty, **options), want, rtol=0,
        atol=0)
    torch.testing.assert_close(
        mas_kernel.mas_path(v, tx, ty, fuse=False, **options), want, rtol=0,
        atol=0)
    fm = mas_kernel.mas_path(v, tx, ty, fuse=False, frame_major=True,
                             **options)
    assert fm.is_contiguous()
    torch.testing.assert_close(fm, want.transpose(1, 2), rtol=0, atol=0)
    if route == "split":
        torch.testing.assert_close(
            mas_kernel.mas_walk_idx(bits, tx, ty),
            mas_kernel.mas_walk_idx_plain(bits, tx, ty), rtol=0, atol=0)


# H13: K chains a block over bytes pre-filled with 0xA5, natural (tiles
# where a chain holds one cell a thread) and frame-major (rows); the odd
# shape, T_x = 1100 (planes in device memory), and columns past a chain's
# plans (the wide form: T_x = 2100 at K = 4, and 7264, the widest that four
# chains' columns fit). Item 0 has t_x > t_y, the last t_x = 0.
@pytest.mark.cuda
@pytest.mark.parametrize("chains", [2, 4])
@pytest.mark.parametrize("seed,B,T_x,T_y", [(50, 8, 45, 300),
                                            (51, 4, 1100, 1300),
                                            (52, 4, 2100, 2200),
                                            (53, 4, 7264, 7280)])
def test_chains_forward_writes_every_byte(cuda, mas_outputs_prefilled, seed,
                                          B, T_x, T_y, chains):
    value, t_x, t_y = ragged(seed, B, T_x, T_y)
    v, tx, ty = (torch.from_numpy(a).to(cuda) for a in (value, t_x, t_y))
    want = mas_kernel.mas_bits(v.cpu(), tx.cpu(), ty.cpu()).to(cuda)
    fm_view = v.transpose(1, 2).contiguous().transpose(1, 2)
    for lattice, contiguous in ((v, True), (fm_view, False)):
        fetch = mas_kernel._chains_plan(T_x, T_y, chains, contiguous)[4]
        assert (fetch == "wide") == (T_x > 8 * 1024 // chains)
        assert fetch != "tiles" or contiguous
        torch.testing.assert_close(
            mas_kernel.mas_bits(lattice, tx, ty, chains=chains), want,
            rtol=0, atol=0)


def shifted(bits, offset):
    """A contiguous copy of `bits` whose data starts `offset` bytes past a
    16-byte boundary."""
    buf = torch.empty(bits.numel() + 16, dtype=torch.uint8,
                      device=bits.device)
    out = buf[offset:offset + bits.numel()].view(bits.shape)
    out.copy_(bits)
    return out


RING_WALKS = {"stage": {"form": "stage"}, "chains2": {"chains": 2},
              "chains4": {"chains": 4}}


# H10 and H14, the ring walk (csrc/mas_walk.cuh), over NaN: each fetch
# (bits at a 16-byte boundary: bulk where the shape allows it; 4 bytes
# past it: 4-byte cp.async where T_x % 4 == 0; 1 byte past it: byte
# loads); rings of 4 stages of 128-frame chunks (64 at K = 4) that hold
# one partial chunk (T_y = 40), exactly one lap (256 at K = 4, 512 at
# K <= 2), more than a lap with a partial chunk (300 at K = 4, 600; T_x %
# 4 != 0, or a bulk copy whose chunks are 16-byte multiples only as whole
# chunks), several laps (1024), and a column past 8192 tokens (four, two
# or one frames a chunk; at one, 8200 bytes are no multiple of 16 and
# 4-byte copies serve). Item 0 has t_x > t_y, the last t_x = 0.
@pytest.mark.cuda
@pytest.mark.parametrize("route", list(RING_WALKS))
@pytest.mark.parametrize("offset", [0, 4, 1])
@pytest.mark.parametrize("seed,B,T_x,T_y", [(60, 4, 16, 40),
                                            (61, 4, 32, 256),
                                            (62, 4, 32, 512),
                                            (63, 4, 20, 600),
                                            (64, 8, 45, 300),
                                            (65, 4, 128, 1024),
                                            (66, 4, 8200, 100)])
def test_ring_walk_matches_plain(cuda, mas_outputs_prefilled, route, offset,
                                 seed, B, T_x, T_y):
    """Bit-identical to the plain walk in both layouts, every cell written
    over NaN, also on bits from elsewhere (bytes of 3, ones at token 0)."""
    options = RING_WALKS[route]
    value, t_x, t_y = ragged(seed, B, T_x, T_y)
    v, tx, ty = (torch.from_numpy(a).to(cuda) for a in (value, t_x, t_y))
    bits = mas_kernel.mas_bits(v, tx, ty)
    foreign = bits * 3
    foreign[:, :, 0] = 1
    for given in (bits, foreign):
        moved = shifted(given, offset)
        _, frames, _, fetch, _ = mas_kernel._walk_plan(
            T_x, T_y, options.get("chains", 1), moved.data_ptr())
        assert fetch == ("bulk" if offset == 0 and T_x * T_y % 16 == 0
                         and frames * T_x % 16 == 0
                         else "async" if offset != 1 and T_x % 4 == 0
                         else "bytes")
        want = mas_kernel._backtrack(given.permute(1, 0, 2) != 0, tx, ty)
        torch.testing.assert_close(
            mas_kernel.mas_backtrack(moved, tx, ty, **options), want,
            rtol=0, atol=0)
        torch.testing.assert_close(
            mas_kernel.mas_backtrack(moved, tx, ty, frame_major=True,
                                     **options), want.transpose(1, 2),
            rtol=0, atol=0)


# H11, the ring walk with one storer warp writing int32 rows, over rows of
# 0x7F7F7F7F: the ring tests' shapes and fetches (bits at a 16-byte
# boundary, 4 and 1 bytes past it), and T_y = 61, whose rows are not all
# 16-byte aligned (one frame a store up to the first aligned frame).
@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 4, 1])
@pytest.mark.parametrize("seed,B,T_x,T_y", [(60, 4, 16, 40),
                                            (61, 4, 32, 256),
                                            (62, 4, 32, 512),
                                            (63, 4, 20, 600),
                                            (64, 8, 45, 300),
                                            (65, 4, 128, 1024),
                                            (66, 4, 8200, 100),
                                            (67, 8, 16, 61)])
def test_idx_walk_matches_plain(cuda, mas_outputs_prefilled, offset, seed,
                                B, T_x, T_y):
    """Equal to `mas_walk_idx_plain` on every frame, also on bits from
    elsewhere (bytes of 3, ones at token 0), each fetch its plan takes."""
    value, t_x, t_y = ragged(seed, B, T_x, T_y)
    v, tx, ty = (torch.from_numpy(a).to(cuda) for a in (value, t_x, t_y))
    bits = mas_kernel.mas_bits(v, tx, ty)
    foreign = bits * 3
    foreign[:, :, 0] = 1
    for given in (bits, foreign):
        moved = shifted(given, offset)
        threads, _, _, fetch, _ = mas_kernel._walk_plan(
            T_x, T_y, 1, moved.data_ptr(),
            threads=mas_kernel.IDX_WALK_THREADS)
        assert threads == 96
        assert fetch == mas_kernel._walk_plan(T_x, T_y, 1,
                                              moved.data_ptr())[3]
        torch.testing.assert_close(
            mas_kernel.mas_walk_idx(moved, tx, ty),
            mas_kernel.mas_walk_idx_plain(given.cpu(), tx.cpu(),
                                          ty.cpu()).to(cuda),
            rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_two_pass_path_never_runs_plain(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on a CUDA tensor")

    for name in ("mas_plain", "_forward_bits", "_backtrack",
                 "mas_walk_idx_plain", "mas_expand_plain"):
        monkeypatch.setattr(mas_kernel, name, refuse)
    value, t_x, t_y = ragged(33, 8, 24, 90)
    v, tx, ty = (torch.from_numpy(a).to(cuda) for a in (value, t_x, t_y))
    at.reset_kernel_launches()
    fused = mas_kernel.mas_path(v, tx, ty)
    for options in TWO_PASS_ROUTES.values():
        assert torch.equal(
            mas_kernel.mas_path(v, tx, ty, fuse=False, **options), fused)
    torch.cuda.synchronize()
    assert at.kernel_launches() == {
        "mas_kernel": 1 + 2 + 1 + 1, "mas_walk_stage_kernel": 1,
        "mas_walk_idx_kernel": 1, "mas_expand_kernel": 1,
        "mas_bits_chains_kernel": 2, "mas_walk_chains_kernel": 2}


@pytest.fixture
def alphas_prefilled_with_nan(monkeypatch):
    """H2 and H5 write into an output pre-filled with NaN, so a cell they
    leave unwritten shows."""
    alphas_out = forward_sum_kernel._alphas_out

    def prefilled(*args):
        return alphas_out(*args).fill_(float("nan"))

    monkeypatch.setattr(forward_sum_kernel, "_alphas_out", prefilled)
    monkeypatch.setattr(skip_dp_kernel, "_alphas_out", prefilled)


# Alpha sweeps: ragged batches (item 0 at t_y = 1); every item at
# t_y = T_y ("full"); T_y = 1; T_x = 1100 (two cells a thread); lp read
# with a strided column ("state").
@pytest.mark.cuda
@pytest.mark.parametrize("seed,B,T_x,T_y,layout", [
    (3, 6, 16, 70, "ragged"), (4, 3, 128, 512, "ragged"),
    (5, 4, 24, 37, "full"), (6, 4, 9, 1, "ragged"),
    (7, 2, 1100, 1300, "ragged"), (8, 5, 40, 61, "state")])
def test_alpha_kernel_matches_plain(cuda, alphas_prefilled_with_nan, seed, B,
                                    T_x, T_y, layout):
    """The whole alpha lattice, frozen frames included, within rtol 1e-5
    of the plain sweep (both follow jnp.logaddexp's formula in float32;
    the exp/log libraries differ), every cell written over NaN, and the
    final column equal to the last row."""
    rng = np.random.default_rng(seed)
    lp = torch.log_softmax(torch.from_numpy(
        rng.standard_normal((B, T_y, T_x)).astype(np.float32)), -1).to(cuda)
    t_x = torch.from_numpy(rng.integers(1, T_x + 1, B)).to(cuda)
    t_y = torch.maximum(t_x, torch.from_numpy(
        rng.integers(1, T_y + 1, B)).to(cuda))
    t_y[0] = 1
    if layout == "full":
        t_y[:] = T_y
    lp_tm = _masked_logp(lp, t_x).transpose(0, 1)
    if layout == "state":
        lp_tm = x_strided(lp_tm)
    alphas, final = forward_sum_kernel.forward_sum_alpha(lp_tm, t_y)
    want = forward_sum_kernel.alpha_plain(lp_tm, t_y)
    torch.testing.assert_close(alphas, want, rtol=1e-5, atol=0)
    torch.testing.assert_close(final, want[-1], rtol=1e-5, atol=0)
    assert torch.equal(final, alphas[-1])


@pytest.fixture
def gamma_prefilled_with_nan(monkeypatch):
    """H3 and H6 write into an output pre-filled with NaN, so a cell they
    leave unwritten shows."""
    gamma_out = forward_sum_kernel._gamma_out

    def prefilled(*args):
        return gamma_out(*args).fill_(float("nan"))

    monkeypatch.setattr(forward_sum_kernel, "_gamma_out", prefilled)
    monkeypatch.setattr(skip_dp_kernel, "_gamma_out", prefilled)


def x_strided(lattice):
    """The same [T_y, B, T] values as a view of a [B, T, T_y] tensor: the
    column axis strided, as a state-major lattice is read."""
    view = lattice.permute(1, 2, 0).contiguous().permute(2, 0, 1)
    assert view.stride(2) != 1 or view.shape[0] == 1
    return view


# Posterior sweeps: ragged batches with edge items; T_y below the ring
# depth of `_sweep_plan` (8 frames) and no multiple of it; every item at
# t_y = T_y ("full"); lp and alphas read with a strided column ("state").
@pytest.mark.cuda
@pytest.mark.parametrize("seed,B,T_x,T_y,layout", [
    (6, 6, 16, 70, "ragged"), (7, 3, 128, 512, "ragged"),
    (8, 2, 1100, 1300, "ragged"), (9, 4, 3, 1, "ragged"),
    (16, 6, 2, 2, "ragged"), (17, 6, 5, 5, "full"), (18, 6, 24, 37, "full"),
    (19, 6, 40, 61, "state"), (20, 5, 1100, 77, "state")])
def test_grad_kernel_matches_plain(cuda, gamma_prefilled_with_nan, seed, B,
                                   T_x, T_y, layout):
    """H3's posterior within rtol 1e-5 / atol 1e-6 of gamma_plain on the
    same alphas, every cell written and exactly 0 off the live cells;
    edge items t_y = 1, t_x > t_y and t_x = 0; T_x = 1100 strides threads
    over T_x > 1024 (two cells a thread)."""
    rng = np.random.default_rng(seed)
    lp = torch.log_softmax(torch.from_numpy(
        rng.standard_normal((B, T_y, T_x)).astype(np.float32)), -1).to(cuda)
    t_x = rng.integers(1, min(T_x, T_y) + 1, B)
    t_y = np.maximum(t_x, rng.integers(1, T_y + 1, B))
    t_x[0], t_y[0] = 1, 1
    if B > 2:
        t_x[1], t_y[1] = T_x, min(max(T_x // 2, 1), T_y)
        t_x[2] = 0
    if layout == "full":
        t_y[:] = T_y
    t_x, t_y = (torch.from_numpy(a.astype(np.int32)).to(cuda)
                for a in (t_x, t_y))
    lp_tm = _masked_logp(lp, t_x).transpose(0, 1)
    alphas, final = forward_sum_kernel.forward_sum_alpha(lp_tm, t_y)
    total = torch.where(_valid_items(t_x, t_y),
                        _total_from_alphas(final, t_x), 0.0)
    if layout == "state":
        lp_tm, alphas = x_strided(lp_tm), x_strided(alphas)
    gamma = forward_sum_kernel.forward_sum_grad(lp_tm, alphas, total, t_x,
                                                t_y)
    want = forward_sum_kernel.gamma_plain(lp_tm, alphas, total, t_x, t_y)
    torch.testing.assert_close(gamma, want, rtol=1e-5, atol=1e-6)
    ys = torch.arange(T_y, device=cuda)[:, None, None]
    live = (ys < t_y[None, :, None]) & (lp_tm > 0.5 * forward_sum_kernel.NEG)
    assert not gamma[~live].any()


@pytest.fixture
def skip_planes(monkeypatch):
    """planes(where) makes H4 keep its move planes in device memory
    ("global") whatever the shape, with its plan's threads, cells and
    fetch and the device-memory ring for them; "shared" keeps the plan."""
    plan = skip_dp_kernel._skip_viterbi_plan

    def force(where):
        if where == "shared":
            return

        def device_memory_plan(T_s, T_y, frames_contiguous):
            threads, cells, _, _, fetch, _ = plan(T_s, T_y,
                                                  frames_contiguous)
            ring = next(r for c, r, p, f in skip_dp_kernel.SKIP_VITERBI_PLANS
                        if (c, p, f) == (cells, "global", fetch))
            return (threads, cells, ring, "global", fetch,
                    skip_dp_kernel._skip_viterbi_smem(threads * cells, ring,
                                                      0))

        monkeypatch.setattr(skip_dp_kernel, "_skip_viterbi_plan",
                            device_memory_plan)

    return force


# Skip Viterbi: each shape with the move planes in shared memory, as
# planned, and in device memory, its values read state-major (frames
# contiguous: tiles of 8 frames, up to 1024 states) and frame-major (rows);
# T_y = 5 below a tile and the ring depth; 1041 states x 700 frames (two
# cells a thread, shared planes behind the shallow ring) and x 1200
# (planes in device memory, as planned).
@pytest.mark.cuda
@pytest.mark.parametrize("seed,B,T_x,T_y,cost,planes", [
    (10, 8, 12, 61, 0.0, "shared"), (10, 8, 12, 61, 0.0, "global"),
    (11, 6, 128, 300, -1.2, "shared"), (11, 6, 128, 300, -1.2, "global"),
    (12, 2, 520, 700, 0.6, "shared"), (27, 2, 520, 1200, -0.4, "global"),
    (28, 6, 3, 5, 0.3, "shared"), (28, 6, 3, 5, 0.3, "global")])
def test_mas_skip_kernel_matches_plain(cuda, skip_planes, seed, B, T_x, T_y,
                                       cost, planes):
    """Bit-identical paths in both layouts and from a frame-major
    lattice read in place, with the move planes in shared or device
    memory; T_s = 1041 > 1024 takes two cells a thread."""
    skip_planes(planes)
    for frames_contiguous in (True, False):
        plan = skip_dp_kernel._skip_viterbi_plan(2 * T_x + 1, T_y,
                                                 frames_contiguous)
        assert plan[3] == planes
        assert plan[4] == ("tiles" if frames_contiguous and T_x < 512
                           else "rows")
    value, t_x, t_y = skip_ragged(seed, B, T_x, T_y)
    v, tx, ty = (torch.from_numpy(a).to(cuda) for a in (value, t_x, t_y))
    path = skip_dp_kernel.mas_skip_path(v, tx, ty, enter_cost=cost)
    want = skip_dp_kernel.mas_skip_plain(v, tx, ty, enter_cost=cost)
    torch.testing.assert_close(path, want, rtol=0, atol=0)
    fm = skip_dp.mas_skip_path_frame_major(
        v.transpose(1, 2).contiguous(), tx, ty, enter_cost=cost)
    assert fm.is_contiguous()
    torch.testing.assert_close(fm, want.transpose(1, 2), rtol=0, atol=0)
    tx[1] = T_x + 1                      # more states than the lattice has
    assert not skip_dp_kernel.mas_skip_path(v, tx, ty)[1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("seed,B,T_x,T_y,cost,layout", [
    (13, 6, 12, 70, 0.0, "ragged"), (14, 6, 128, 300, -1.3, "ragged"),
    (15, 2, 520, 700, 0.8, "ragged"), (21, 6, 1, 1, 0.5, "ragged"),
    (22, 6, 2, 2, -0.7, "ragged"), (23, 6, 4, 5, 0.3, "full"),
    (24, 6, 12, 37, -1.0, "full"), (25, 6, 12, 43, 0.6, "state"),
    (26, 2, 520, 601, 0.2, "state")])
def test_skip_sweep_kernels_match_plain(cuda, gamma_prefilled_with_nan,
                                        seed, B, T_x, T_y, cost, layout):
    """H5's alpha lattice and H6's posterior within rtol 1e-5 / atol 1e-6
    of the plain sweeps on the card, every cell of gamma written and
    exactly 0 off the live cells, and the loss's backward equal to the
    plain route's; T_x = 520 strides threads over T_s = 1041 > 1024."""
    value, t_x, t_y = skip_ragged(seed, B, T_x, T_y)
    if layout == "full":
        t_y[:] = T_y
    lp = torch.log_softmax(torch.from_numpy(value).transpose(1, 2), -1) \
        .contiguous().to(cuda)
    t_x, t_y = (torch.from_numpy(a).to(cuda) for a in (t_x, t_y))
    lp_tm = _masked_logp(lp, skip_dp.n_states(t_x)).transpose(0, 1)
    alphas, final = skip_dp_kernel.forward_sum_skip_alpha(lp_tm, t_y, cost)
    want = skip_dp_kernel.alpha_skip_plain(lp_tm, t_y, cost)
    torch.testing.assert_close(alphas, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(final, alphas[-1], rtol=0, atol=0)
    valid = skip_dp._valid_items_skip(t_x, t_y, lp.shape[2])
    total = torch.where(valid,
                        skip_dp._total_from_alphas_skip(final, t_x), 0.0)
    if layout == "state":
        lp_tm, alphas = x_strided(lp_tm), x_strided(alphas)
    gamma = skip_dp_kernel.forward_sum_skip_grad(lp_tm, alphas, total, t_x,
                                                 t_y, cost)
    want = skip_dp_kernel.gamma_skip_plain(lp_tm, alphas, total, t_x, t_y,
                                           cost)
    torch.testing.assert_close(gamma, want, rtol=1e-5, atol=1e-6)
    ys = torch.arange(lp.shape[1], device=cuda)[:, None, None]
    live = (ys < t_y[None, :, None]) & (lp_tm > 0.5 * skip_dp_kernel.NEG)
    assert not gamma[~live].any()
    x = lp.clone().requires_grad_()
    skip_dp.forward_sum_skip_loss(x, t_x, t_y, cost).sum().backward()
    torch.testing.assert_close(
        x.grad, -want.transpose(0, 1) * valid[:, None, None], rtol=1e-5,
        atol=1e-6)


def skip_alpha_inputs(seed, B, T_x, T_y):
    """A skip lattice [T_y, B, 2*T_x+1] of log-softmax rows, NEG-masked
    past each item's states, with the edge items of chip_smoke.py's
    `skip_fs_inputs`: t_y = 1; t_x > t_y; t_x = 0; a NEG band around the
    diagonal; a fully dead frame; -inf inputs (clamped to NEG)."""
    rng = np.random.default_rng(seed)
    T_s = 2 * T_x + 1
    lp = torch.log_softmax(torch.from_numpy(rng.standard_normal(
        (B, T_y, T_s)).astype(np.float32) * 3), -1).numpy()
    t_x = rng.integers(1, T_x + 1, B).astype(np.int32)
    t_y = np.maximum(t_x, rng.integers(1, T_y + 1, B)).astype(np.int32)
    t_x[0], t_y[0] = 1, 1
    t_x[1], t_y[1] = T_x, max(T_x // 2, 1)
    t_x[2] = 0
    center = np.arange(T_y)[:, None] * (2 * t_x[3] + 1) // t_y[3]
    lp[3] = np.where(np.abs(np.arange(T_s)[None, :] - center) <= 3, lp[3],
                     skip_dp_kernel.NEG)
    lp[4, t_y[4] // 2, :] = skip_dp_kernel.NEG
    lp[5] = np.where(rng.random((T_y, T_s)) < 0.1, -np.inf, lp[5])
    return lp, t_x, t_y


@pytest.mark.cuda
@pytest.mark.parametrize("cost", [0.0, -1.2, 0.6])
@pytest.mark.parametrize("seed,B,T_x,T_y,layout", [
    (40, 8, 12, 70, "ragged"), (41, 6, 128, 300, "ragged"),
    (42, 6, 520, 400, "ragged"), (43, 6, 40, 61, "state")])
def test_skip_alpha_kernel_matches_plain(cuda, alphas_prefilled_with_nan,
                                         seed, B, T_x, T_y, layout, cost):
    """H5's whole alpha lattice, frozen frames included, written over NaN,
    within rtol 1e-5 / atol 1e-6 of alpha_skip_plain with the edge items,
    at T_s = 1041 (two cells a thread) and with a strided state axis; the
    final column equal to the last frame."""
    lp, t_x, t_y = skip_alpha_inputs(seed, B, T_x, T_y)
    t_x, t_y = (torch.from_numpy(a).to(cuda) for a in (t_x, t_y))
    lp_tm = _masked_logp(torch.from_numpy(lp).to(cuda),
                         skip_dp.n_states(t_x)).transpose(0, 1)
    if layout == "state":
        lp_tm = x_strided(lp_tm)
    alphas, final = skip_dp_kernel.forward_sum_skip_alpha(lp_tm, t_y, cost)
    want = skip_dp_kernel.alpha_skip_plain(lp_tm, t_y, cost)
    torch.testing.assert_close(alphas, want, rtol=1e-5, atol=1e-6)
    assert torch.equal(final, alphas[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("seed,B,T_x,T_y,D", [(20, 6, 12, 40, 6),
                                              (21, 5, 128, 300, 4),
                                              (22, 4, 40, 1100, 32),
                                              (23, 4, 12, 130, 32),
                                              (24, 4, 90, 90, 1),
                                              (25, 64, 128, 1024, 32)])
def test_mobo_kernels_match_plain(cuda, seed, B, T_x, T_y, D):
    """H7 and H9 within rtol 1e-6 / atol 1e-5 of the plain sweeps on live
    cells and below NEG / 2 on dead ones; H8's backpointers equal on
    tokens < t_x and 0 past them, its walk's durations equal. H8 strides
    threads over T_y1 = 1101 > 1024 in the third case; the second has an
    odd T_y1 that is no multiple of the block size. H7 and H9 run in the
    clusters of `_cluster_plan`: slices barely wider than D in the fourth
    case (T_y1 = 131, D = 32), D = 1 in the fifth, and at B = 64 x 1025 a
    smaller cluster whose z rows live in the output; item 1 has t_x = T_x
    in every case."""
    energies, t_x, t_y = mobo_ragged(seed, B, T_x, T_y, D)
    tx, ty = (torch.from_numpy(a).to(cuda) for a in (t_x, t_y))
    e_tm = mobo._prep_energies(torch.from_numpy(energies).to(cuda), tx, ty)
    for got, want in (
            (mobo_kernel.mobo_alpha(e_tm, tx, D),
             mobo_kernel.mobo_alpha_plain(e_tm, tx, D)),
            (mobo_kernel.mobo_beta(e_tm, tx, ty, D),
             mobo_kernel.mobo_beta_plain(e_tm, tx, ty, D))):
        live = want > 0.5 * mobo_kernel.NEG
        torch.testing.assert_close(got[live], want[live], rtol=1e-6,
                                   atol=1e-5)
        assert (got[~live] <= 0.5 * mobo_kernel.NEG).all()
    bp, durs = mobo_kernel.mobo_bp(e_tm, tx, ty, D)
    want_bp, want_durs = mobo_kernel.mobo_bp_plain(e_tm, tx, ty, D)
    live_tokens = torch.arange(T_x, device=cuda)[:, None, None] \
        < tx[None, :, None]
    torch.testing.assert_close(bp * live_tokens, want_bp * live_tokens,
                               rtol=0, atol=0)
    assert not (bp * ~live_tokens).any()
    torch.testing.assert_close(durs, want_durs, rtol=0, atol=0)
    ok = (tx >= 1) & (ty <= tx * D)
    assert torch.equal(durs.sum(1)[ok], ty[ok].long())
    # a transposed view is read in place
    view = e_tm.permute(1, 2, 0).contiguous().permute(2, 0, 1)
    torch.testing.assert_close(mobo_kernel.mobo_alpha(view, tx, D),
                               mobo_kernel.mobo_alpha(e_tm, tx, D),
                               rtol=0, atol=0)


@pytest.fixture
def mobo_bp_forced(monkeypatch):
    """force(form) runs H8 as planned ("planned") or in its wide form
    ("wide"); its outputs start as garbage (backpointers -7, durations
    -1), so a cell it leaves unwritten shows."""
    plan, outs = mobo_kernel._bp_plan, mobo_kernel._bp_outs
    monkeypatch.setattr(mobo_kernel, "_bp_outs", lambda *args: tuple(
        o.fill_(v) for o, v in zip(outs(*args), (-7, -1))))

    def force(form):
        def forced(B, T_x, n, D):
            if form == "wide":
                return 0, n, False, 4 * (3 * n + 4 * D)
            return plan(B, T_x, n, D)

        monkeypatch.setattr(mobo_kernel, "_bp_plan", forced)

    return force


# H8 at D = 1, 4 and 32, 1000 and 4000; T_y1 = 131 (slices barely wider
# than D), 1101 and 1025 at B = 16 (z in shared memory) and B = 64 (z in
# the bp rows); T_y1 = 9001 with D = 4000, which only the wide form holds;
# B = 133, more items than SMs, which the plan gives the wide form. Edge
# items: t_x = 1, t_x = T_x, no boundary sequence, t_x = 0,
# ties everywhere (item 4) and t_x > t_y (item 5, the clamp).
@pytest.mark.cuda
@pytest.mark.parametrize("form", ["planned", "wide"])
@pytest.mark.parametrize("seed,B,T_x,T_y,D", [(40, 6, 40, 30, 1),
                                              (41, 6, 128, 300, 4),
                                              (42, 16, 128, 1024, 32),
                                              (43, 6, 12, 130, 32),
                                              (44, 6, 40, 1100, 32),
                                              (45, 64, 128, 1024, 32),
                                              (46, 6, 8, 2000, 1000),
                                              (47, 6, 4, 9000, 4000),
                                              (48, 133, 16, 60, 4)])
def test_mobo_bp_kernel_matches_plain(cuda, mobo_bp_forced, seed, B, T_x,
                                      T_y, D, form):
    """Backpointers on tokens < t_x and durations equal to mobo_bp_plain's,
    backpointers 0 on tokens >= t_x, every cell written over garbage; the
    durations of an item with a boundary sequence tile t_y in steps of
    1..D."""
    mobo_bp_forced(form)
    energies, t_x, t_y = mobo_ragged(seed, B, T_x, T_y, D)
    energies[4] = 0.0
    t_x[5], t_y[5] = T_x, 1
    tx, ty = (torch.from_numpy(a).to(cuda) for a in (t_x, t_y))
    e_tm = mobo._prep_energies(torch.from_numpy(energies).to(cuda), tx, ty)
    plan = mobo_kernel._bp_plan(B, T_x, T_y + 1, D)
    assert (plan[0] == 0) == (form == "wide" or T_y == 9000
                              or B > mobo_kernel.SMS)
    bp, durs = mobo_kernel.mobo_bp(e_tm, tx, ty, D)
    want_bp, want_durs = mobo_kernel.mobo_bp_plain(e_tm, tx, ty, D)
    live = torch.arange(T_x, device=cuda)[:, None, None] < tx[None, :, None]
    torch.testing.assert_close(bp * live, want_bp * live, rtol=0, atol=0)
    assert not (bp * ~live).any()
    torch.testing.assert_close(durs, want_durs, rtol=0, atol=0)
    ok = (tx >= 1) & (tx <= ty) & (ty <= tx * D)
    inside = live[:, :, 0].T
    assert torch.equal(durs.sum(1)[ok], ty[ok].long())
    assert ((durs >= 1) & (durs <= D))[inside & ok[:, None]].all()
    assert not durs[~inside].any()


@pytest.mark.cuda
def test_cuda_mobo_path_never_runs_plain(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on a CUDA tensor")

    for module, name in ((forward_sum_kernel, "alpha_plain"),
                         (forward_sum_kernel, "gamma_plain"),
                         (mobo_kernel, "mobo_alpha_plain"),
                         (mobo_kernel, "mobo_bp_plain"),
                         (mobo_kernel, "mobo_beta_plain")):
        monkeypatch.setattr(module, name, refuse)
    at.reset_kernel_launches()
    batch = dict(zip(("tokens", "mel", "text_lengths", "mel_lengths"),
                     (t.to(cuda) for t in small_batch())))
    for cls, config in MOBO_FAMILIES:
        model = cls(config, device=cuda)
        with torch.no_grad():
            out = model(*batch.values())
        assert torch.equal(out["hard_durations"].sum(1),
                           batch["mel_lengths"])
        state = create_train_state(model, learning_rate=1e-3)
        step = make_train_step(
            model, apply_extra=lambda n: {"compute_hard": False},
            objective=lambda out, n: (
                out["loss_recon"] + 0.1 * out.get("loss", out.get(
                    "loss_mobo")), {"loss_recon": out["loss_recon"]}))
        for _ in range(2):
            state, metrics = step(state, batch)
        assert all(torch.isfinite(torch.as_tensor(v))
                   for v in metrics.values())
    x = torch.randn((3, 30, 9), device=cuda, requires_grad=True)
    mobo.mobo_loss(x, batch["text_lengths"], batch["mel_lengths"],
                   6).backward()
    assert torch.isfinite(x.grad).all()
    torch.cuda.synchronize()
    assert at.kernel_launches() == {
        "mobo_alpha_kernel": 7, "mobo_beta_kernel": 7, "mobo_bp_kernel": 2,
        "forward_sum_alpha_kernel": 3, "forward_sum_grad_kernel": 3}


@pytest.mark.cuda
def test_cuda_pause_path_never_runs_plain(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on a CUDA tensor")

    for module, name in ((mas_kernel, "mas_plain"),
                         (forward_sum_kernel, "alpha_plain"),
                         (forward_sum_kernel, "gamma_plain"),
                         (skip_dp_kernel, "mas_skip_plain"),
                         (skip_dp_kernel, "alpha_skip_plain"),
                         (skip_dp_kernel, "gamma_skip_plain")):
        monkeypatch.setattr(module, name, refuse)
    at.reset_kernel_launches()
    model = at.OTAAligner(at.OTAConfig(
        vocab_size=20, dim=16, hidden=32, use_recon=True, model_pauses=True,
        pause_silence_anchor=0.5, pause_enter_cost=-0.3), device=cuda)
    state = create_train_state(model, learning_rate=1e-3)
    batch = dict(zip(("tokens", "mel", "text_lengths", "mel_lengths"),
                     small_batch()))
    step = make_train_step(
        model, bin_start=0, bin_ramp=1,
        apply_extra=lambda n: {"pause_bias": -3.0 + n})
    for _ in range(2):
        state, metrics = step(state, {k: v.to(cuda)
                                      for k, v in batch.items()})
    assert all(torch.isfinite(torch.as_tensor(v)) for v in metrics.values())
    assert model.pause_key.abs().max() > 0
    value, t_x, t_y = skip_ragged(16, 6, 4, 30)
    lats = [value[i, :2 * t_x[i] + 1, :t_y[i]] for i in (0, 1, 4, 5)]
    served = at.SkipBatchAligner(max_text=4, max_mel=30, max_batch=3,
                                 device=cuda).align(lats)
    assert all(tok.sum() + pause.sum() == lat.shape[1]
               for lat, (_, tok, pause) in zip(lats, served))
    torch.cuda.synchronize()
    assert at.kernel_launches() == {"mas_skip_kernel": 4,
                                    "forward_sum_skip_alpha_kernel": 2,
                                    "forward_sum_skip_gamma_kernel": 2}


@pytest.mark.cuda
def test_cuda_main_path_never_runs_plain(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on a CUDA tensor")

    monkeypatch.setattr(mas_kernel, "mas_plain", refuse)
    monkeypatch.setattr(forward_sum_kernel, "alpha_plain", refuse)
    monkeypatch.setattr(forward_sum_kernel, "gamma_plain", refuse)
    at.reset_kernel_launches()
    value, t_x, t_y = ragged(5, 4, 8, 30)
    mask = ((np.arange(8)[None, :, None] < t_x[:, None, None])
            & (np.arange(30)[None, None, :] < t_y[:, None, None]))
    at.maximum_path(torch.from_numpy(value).to(cuda),
                    torch.from_numpy(mask).to(cuda))
    out = small_ota(cuda)
    lp = out["logp_with_prior"].requires_grad_()
    forward_sum_loss(lp, torch.tensor([9, 5, 2], device=cuda),
                     torch.tensor([30, 17, 6], device=cuda)).sum().backward()
    assert torch.isfinite(lp.grad).all()
    model = at.OTAAligner(at.OTAConfig(vocab_size=20, dim=16, hidden=32,
                                       use_recon=True), device=cuda)
    state = create_train_state(model, learning_rate=1e-3)
    batch = dict(zip(("tokens", "mel", "text_lengths", "mel_lengths"),
                     small_batch()))
    step = make_train_step(model, bin_start=0, bin_ramp=1)
    for _ in range(2):
        state, metrics = step(state, {k: v.to(cuda)
                                      for k, v in batch.items()})
    assert all(torch.isfinite(torch.as_tensor(v)) for v in metrics.values())
    aligner = at.BatchAligner(max_text=8, max_mel=30, max_batch=2,
                              device=cuda)
    lats = [value[i, :max(t_x[i], 1), :t_y[i]] for i in range(1, 4)]
    aligner.align(lats)
    aligner.align_durations(lats)
    torch.cuda.synchronize()
    launches = at.kernel_launches()
    assert launches["mas_kernel"] >= 8
    assert launches["forward_sum_alpha_kernel"] >= 4
    assert launches["forward_sum_grad_kernel"] >= 3


@pytest.mark.cuda
def test_cpp_route_equals_h1_on_the_card(cuda):
    """`maximum_path(implementation="cpp")` on CUDA tensors: the host
    oracle's path, back on the card in value's dtype, equals H1's; "auto"
    still launches H1."""
    value, t_x, t_y = ragged(6, 8, 32, 96)
    t_x[0], t_x[-1] = 16, 1                # the oracle takes 1 <= t_x <= t_y
    mask = ((np.arange(32)[None, :, None] < t_x[:, None, None])
            & (np.arange(96)[None, None, :] < t_y[:, None, None]))
    v = torch.from_numpy(value).to(cuda)
    m = torch.from_numpy(mask.astype(np.float32)).to(cuda)
    at.reset_kernel_launches()
    host = at.maximum_path(v, m, implementation="cpp")
    assert at.kernel_launches() == {}
    assert host.device == v.device and host.dtype == v.dtype
    assert torch.equal(host, at.maximum_path(v, m))
    assert at.kernel_launches() == {"mas_kernel": 1}


@pytest.mark.cuda
def test_bf16_forward_on_the_card_launches_h1_to_h3(cuda, monkeypatch):
    """The bfloat16 OTA forward and a backward on the card: float32
    parameters and lattice, H1 for the hard path, H2 and H3 for the
    forward-sum loss, no plain version."""
    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on a CUDA tensor")

    monkeypatch.setattr(mas_kernel, "mas_plain", refuse)
    monkeypatch.setattr(forward_sum_kernel, "alpha_plain", refuse)
    monkeypatch.setattr(forward_sum_kernel, "gamma_plain", refuse)
    model = at.OTAAligner(at.OTAConfig(vocab_size=20, dim=16, hidden=32,
                                       use_recon=True,
                                       compute_dtype="bfloat16"),
                          device=cuda)
    at.reset_kernel_launches()
    out = model(*[t.to(cuda) for t in small_batch()])
    (out["loss_forward_sum"] + out["loss_recon"]).backward()
    torch.cuda.synchronize()
    assert out["log_attn"].dtype == torch.float32
    assert all(p.dtype == torch.float32 and torch.isfinite(p.grad).all()
               for p in model.parameters())
    assert at.kernel_launches() == {"mas_kernel": 1,
                                    "forward_sum_alpha_kernel": 1,
                                    "forward_sum_grad_kernel": 1}


@pytest.mark.cuda
def test_measure_device_time_sees_h1(cuda):
    from aligner_tpu_torch.utils.profiling import (device_time_by_kernel,
                                                   measure_device_time)
    value, t_x, t_y = ragged(7, 8, 32, 96)
    v, tx, ty = (torch.from_numpy(a).to(cuda) for a in (value, t_x, t_y))
    times = device_time_by_kernel(lambda: mas_kernel.mas_path(v, tx, ty),
                                  iters=5, name_prefix="mas_kernel")
    assert times and all(s > 0 for s in times.values())
    whole = measure_device_time(mas_kernel.mas_path, v, tx, ty, iters=5)
    assert whole >= 0.5 * sum(times.values())
