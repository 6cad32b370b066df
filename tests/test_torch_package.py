"""aligner_tpu_torch as a package: it never imports jax, it picks a kernel
or its plain version by the tensor's device alone, and on a card its
kernels agree with their plain versions and the main path never touches
a plain version.

This file imports no JAX, so the tests marked `cuda` also run on a GPU
machine that has none (the repo's conftest imports jax, hence
--noconftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_package.py
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import aligner_tpu_torch as at
from aligner_tpu_torch.ops import (forward_sum_kernel, mas_kernel, skip_dp,
                                   skip_dp_kernel)
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
            "             'ops.skip_dp_reference'):\n"
            "    assert 'aligner_tpu_torch.' + name in sys.modules, name\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


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
    assert at.kernel_launches() == {}


@pytest.mark.parametrize("call", ["mas_path", "mas_durations",
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
        else:
            getattr(mas_kernel, call)(value, lengths, lengths)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,B,T_x,T_y", [(0, 8, 16, 61), (1, 5, 40, 200),
                                            (2, 2, 1100, 1300)])
def test_mas_kernel_matches_plain(cuda, seed, B, T_x, T_y):
    """Bit-identical paths, durations and frame-major output; the last
    case strides threads over T_x > 1024."""
    value, t_x, t_y = ragged(seed, B, T_x, T_y)
    v, tx, ty = (torch.from_numpy(a).to(cuda) for a in (value, t_x, t_y))
    path = mas_kernel.mas_path(v, tx, ty)
    torch.testing.assert_close(path, mas_kernel.mas_plain(v, tx, ty),
                               rtol=0, atol=0)
    torch.testing.assert_close(mas_kernel.mas_durations(v, tx, ty),
                               path.sum(-1).to(torch.int32), rtol=0, atol=0)
    fm = mas_kernel.mas_path(v.transpose(1, 2).contiguous().transpose(1, 2),
                             tx, ty, frame_major=True)
    torch.testing.assert_close(fm, path.transpose(1, 2), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,B,T_x,T_y", [(3, 6, 16, 70), (4, 3, 128, 512)])
def test_alpha_kernel_matches_plain(cuda, seed, B, T_x, T_y):
    """Alpha lattice within rtol 1e-5 of the plain sweep (both follow
    jnp.logaddexp's formula in float32; the exp/log libraries differ)."""
    rng = np.random.default_rng(seed)
    lp = torch.log_softmax(torch.from_numpy(
        rng.standard_normal((B, T_y, T_x)).astype(np.float32)), -1).to(cuda)
    t_x = torch.from_numpy(rng.integers(1, T_x + 1, B)).to(cuda)
    t_y = torch.maximum(t_x, torch.from_numpy(
        rng.integers(1, T_y + 1, B)).to(cuda))
    lp_tm = _masked_logp(lp, t_x).transpose(0, 1)
    alphas, final = forward_sum_kernel.forward_sum_alpha(lp_tm, t_y)
    want = forward_sum_kernel.alpha_plain(lp_tm, t_y)
    torch.testing.assert_close(alphas, want, rtol=1e-5, atol=0)
    torch.testing.assert_close(final, want[-1], rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,B,T_x,T_y", [(6, 6, 16, 70), (7, 3, 128, 512),
                                            (8, 2, 1100, 1300)])
def test_grad_kernel_matches_plain(cuda, seed, B, T_x, T_y):
    """H3's posterior within rtol 1e-5 / atol 1e-6 of gamma_plain on the
    same alphas, exactly 0 off the live cells; edge items t_y = 1,
    t_x > t_y and t_x = 0; the last case strides threads over
    T_x > 1024."""
    rng = np.random.default_rng(seed)
    lp = torch.log_softmax(torch.from_numpy(
        rng.standard_normal((B, T_y, T_x)).astype(np.float32)), -1).to(cuda)
    t_x = rng.integers(1, T_x + 1, B)
    t_y = np.maximum(t_x, rng.integers(1, T_y + 1, B))
    t_x[0], t_y[0] = 1, 1
    if B > 2:
        t_x[1], t_y[1] = T_x, T_x // 2
        t_x[2] = 0
    t_x, t_y = (torch.from_numpy(a.astype(np.int32)).to(cuda)
                for a in (t_x, t_y))
    lp_tm = _masked_logp(lp, t_x).transpose(0, 1)
    alphas, final = forward_sum_kernel.forward_sum_alpha(lp_tm, t_y)
    total = torch.where(_valid_items(t_x, t_y),
                        _total_from_alphas(final, t_x), 0.0)
    gamma = forward_sum_kernel.forward_sum_grad(lp_tm, alphas, total, t_x,
                                                t_y)
    want = forward_sum_kernel.gamma_plain(lp_tm, alphas, total, t_x, t_y)
    torch.testing.assert_close(gamma, want, rtol=1e-5, atol=1e-6)
    ys = torch.arange(T_y, device=cuda)[:, None, None]
    live = (ys < t_y[None, :, None]) & (lp_tm > 0.5 * forward_sum_kernel.NEG)
    assert not gamma[~live].any()


@pytest.mark.cuda
@pytest.mark.parametrize("seed,B,T_x,T_y,cost", [(10, 8, 12, 61, 0.0),
                                                 (11, 6, 128, 300, -1.2),
                                                 (12, 2, 520, 700, 0.6)])
def test_mas_skip_kernel_matches_plain(cuda, seed, B, T_x, T_y, cost):
    """Bit-identical paths in both layouts and from a frame-major
    lattice read in place; the last case strides threads over
    T_s = 1041 > 1024."""
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
@pytest.mark.parametrize("seed,B,T_x,T_y,cost", [(13, 6, 12, 70, 0.0),
                                                 (14, 6, 128, 300, -1.3),
                                                 (15, 2, 520, 700, 0.8)])
def test_skip_sweep_kernels_match_plain(cuda, seed, B, T_x, T_y, cost):
    """H5's alpha lattice and H6's posterior within rtol 1e-5 / atol 1e-6
    of the plain sweeps on the card, gamma exactly 0 off the live cells,
    and the loss's backward equal to the plain route's; the last case
    strides threads over T_s = 1041 > 1024."""
    value, t_x, t_y = skip_ragged(seed, B, T_x, T_y)
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
