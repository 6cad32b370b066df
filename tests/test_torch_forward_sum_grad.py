"""aligner_tpu_torch forward-sum backward against the JAX package (CPU
route): `gamma_plain`, the plain version of kernel H3, against the Pallas
beta/grad kernel in interpret mode and against the lax `_beta_scan`
posterior, on the edge cases of tests/test_forward_sum_pallas.py; the
loss gradient against `jax.grad` at rtol 1e-5 / atol 1e-6; and
`forward_sum_loss_with_posteriors` against its JAX counterpart."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aligner_tpu.ops import forward_sum as jax_fs
from aligner_tpu.ops.forward_sum_pallas import forward_sum_grad_pallas
from aligner_tpu_torch import _build
from aligner_tpu_torch.ops import forward_sum_kernel
from aligner_tpu_torch.ops.forward_sum import (
    _masked_logp, _total_from_alphas, _valid_items, forward_sum_loss,
    forward_sum_loss_with_posteriors)
from aligner_tpu_torch.ops.forward_sum_kernel import (NEG, alpha_plain,
                                                      forward_sum_grad,
                                                      gamma_plain)


def log_softmax(raw):
    return np.array(jax.nn.log_softmax(jnp.asarray(raw), axis=-1))


def ragged(seed, B=4, T_x=12, T_y=32):
    rng = np.random.default_rng(seed)
    logp = log_softmax(rng.standard_normal((B, T_y, T_x)).astype(np.float32))
    t_x = rng.integers(1, T_x + 1, B)
    t_y = np.maximum(t_x, rng.integers(1, T_y + 1, B))
    return logp, t_x.astype(np.int32), t_y.astype(np.int32)


def edge_t_y_1():
    """t_y == 1 (so t_x == 1) beside normal items."""
    rng = np.random.default_rng(21)
    logp = log_softmax(rng.standard_normal((3, 16, 8)).astype(np.float32))
    return logp, np.array([1, 5, 8], np.int32), np.array([1, 12, 16],
                                                         np.int32)


def edge_invalid():
    """t_x > t_y and t_x == 0 beside a normal item."""
    logp, t_x, t_y = ragged(22, B=3, T_x=8, T_y=12)
    t_x[:] = [8, 0, 3]
    t_y[:] = [6, 9, 12]
    return logp, t_x, t_y


def edge_banded():
    """Most labels NEG-saturated per frame (a narrow diagonal band stays
    live, as an extreme prior gives)."""
    rng = np.random.default_rng(27)
    logp = log_softmax(rng.standard_normal((2, 16, 8)).astype(np.float32))
    t_x, t_y = np.array([6, 8], np.int32), np.array([16, 14], np.int32)
    center = (np.arange(16)[None, :, None] * t_x[:, None, None]
              // t_y[:, None, None])
    logp = np.where(np.abs(np.arange(8)[None, None, :] - center) <= 1, logp,
                    NEG).astype(np.float32)
    return logp, t_x, t_y


def edge_dead_frame():
    """A frame whose every label is NEG: zero path mass."""
    rng = np.random.default_rng(29)
    logp = log_softmax(rng.standard_normal((2, 16, 8)).astype(np.float32))
    logp[:, 5, :] = NEG
    return logp, np.array([6, 8], np.int32), np.array([16, 14], np.int32)


def edge_neg_inf():
    """-inf at text positions past t_x and at a few live cells, as a
    caller's masked softmax gives."""
    logp, t_x, t_y = ragged(31, B=3, T_x=9, T_y=24)
    logp = np.where(np.arange(9)[None, None, :] < t_x[:, None, None], logp,
                    -np.inf)
    logp[0, 3, 0] = -np.inf
    return logp.astype(np.float32), t_x, t_y


CASES = {"seed0": lambda: ragged(0), "seed1": lambda: ragged(1),
         "seed2": lambda: ragged(2, B=3, T_x=5, T_y=40),
         "t_y_1": edge_t_y_1, "invalid": edge_invalid,
         "banded": edge_banded, "dead_frame": edge_dead_frame,
         "neg_inf": edge_neg_inf}


def sweep_inputs(logp, t_x, t_y):
    """(lp_tm, alphas, total) as the loss hands them to the beta sweep:
    masked lattice, its alpha lattice, totals zeroed on invalid items."""
    tx, ty = torch.from_numpy(t_x), torch.from_numpy(t_y)
    lp_tm = _masked_logp(torch.from_numpy(logp), tx).transpose(0, 1)
    alphas = alpha_plain(lp_tm, ty)
    total = torch.where(_valid_items(tx, ty),
                        _total_from_alphas(alphas[-1], tx), 0.0)
    return lp_tm, alphas, total


@pytest.mark.parametrize("case", sorted(CASES))
def test_gamma_plain_matches_pallas_kernel(case):
    logp, t_x, t_y = CASES[case]()
    lp_tm, alphas, total = sweep_inputs(logp, t_x, t_y)
    got = gamma_plain(lp_tm, alphas, total, torch.from_numpy(t_x),
                      torch.from_numpy(t_y))
    want = forward_sum_grad_pallas(
        jnp.asarray(lp_tm.contiguous().numpy()), jnp.asarray(alphas.numpy()),
        jnp.asarray(total.numpy()), jnp.asarray(t_x), jnp.asarray(t_y),
        interpret=True)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # exactly 0 off the live cells
    live = ((np.arange(lp_tm.shape[0])[:, None, None] < t_y[None, :, None])
            & (lp_tm.numpy() > 0.5 * NEG))
    assert (got.numpy()[~live] == 0).all()


@pytest.mark.parametrize("case", ["seed0", "seed1", "seed2", "t_y_1",
                                  "banded"])
def test_gamma_plain_matches_lax_beta_scan(case):
    """Against gamma = exp(alpha + beta - total) from the lax scans (the
    JAX package's CPU route and oracle); per-frame occupancy sums to 1."""
    logp, t_x, t_y = CASES[case]()
    lp_tm, alphas, total = sweep_inputs(logp, t_x, t_y)
    got = gamma_plain(lp_tm, alphas, total, torch.from_numpy(t_x),
                      torch.from_numpy(t_y)).numpy()
    jlp = jnp.asarray(lp_tm.contiguous().numpy())
    jal = jax_fs._alpha_scan(jlp, jnp.asarray(t_y))
    betas = jax_fs._beta_scan(jlp, jnp.asarray(t_x), jnp.asarray(t_y))
    jtot = jax_fs._total_from_alphas(jal, jnp.asarray(t_x),
                                     jnp.asarray(t_y))
    want = np.exp(np.asarray(jal) + np.asarray(betas)
                  - np.asarray(jtot)[None, :, None])
    T_y, _, T_x = lp_tm.shape
    in_range = ((np.arange(T_y)[:, None, None] < t_y[None, :, None])
                & (np.arange(T_x)[None, None, :] < t_x[None, :, None]))
    np.testing.assert_allclose(got, np.where(in_range, want, 0.0),
                               rtol=1e-4, atol=1e-5)
    occupancy = got.sum(-1)
    for b in range(len(t_x)):
        np.testing.assert_allclose(occupancy[:t_y[b], b], 1.0, rtol=1e-4)


# On a zero-mass item (dead_frame) the posterior is 0/0: the JAX
# package's lax route and its Pallas kernel give different finite values
# there, and the port follows the kernel (tested above against it).
@pytest.mark.parametrize("case", sorted(set(CASES) - {"dead_frame"}))
def test_loss_gradient_matches_jax_grad(case):
    logp, t_x, t_y = CASES[case]()
    weights = np.random.default_rng(5).uniform(
        0.5, 2.0, len(t_x)).astype(np.float32)
    x = torch.from_numpy(logp).requires_grad_()
    loss = forward_sum_loss(x, torch.from_numpy(t_x), torch.from_numpy(t_y))
    (loss * torch.from_numpy(weights)).sum().backward()
    want_loss, want_grad = jax.value_and_grad(
        lambda lp: (jax_fs.forward_sum_loss(lp, jnp.asarray(t_x),
                                            jnp.asarray(t_y))
                    * weights).sum())(jnp.asarray(logp))
    assert torch.isfinite(x.grad).all()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float((loss.detach().numpy() * weights).sum()),
                               float(want_loss), rtol=1e-5)
    valid = (t_x >= 1) & (t_x <= t_y)
    assert (x.grad.numpy()[~valid] == 0).all()


@pytest.mark.parametrize("case", ["seed0", "invalid", "neg_inf"])
def test_with_posteriors_matches_jax(case):
    logp, t_x, t_y = CASES[case]()
    x = torch.from_numpy(logp).requires_grad_()
    loss, gamma = forward_sum_loss_with_posteriors(
        x, torch.from_numpy(t_x), torch.from_numpy(t_y))
    assert not gamma.requires_grad
    (jloss, jgamma), vjp = jax.vjp(
        lambda lp: jax_fs.forward_sum_loss_with_posteriors(
            lp, jnp.asarray(t_x), jnp.asarray(t_y)), jnp.asarray(logp))
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jloss),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gamma.numpy(), np.asarray(jgamma), rtol=1e-5,
                               atol=1e-6)
    g = np.linspace(0.5, 1.5, len(t_x)).astype(np.float32)
    loss.backward(torch.from_numpy(g))
    want, = vjp((jnp.asarray(g), jnp.zeros_like(jgamma)))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # the backward reuses gamma: the same gradient as forward_sum_loss
    y = torch.from_numpy(logp).requires_grad_()
    forward_sum_loss(y, torch.from_numpy(t_x),
                     torch.from_numpy(t_y)).backward(torch.from_numpy(g))
    torch.testing.assert_close(x.grad, y.grad)


def test_dead_frame_gradient_is_finite():
    logp, t_x, t_y = edge_dead_frame()
    x = torch.from_numpy(logp).requires_grad_()
    loss = forward_sum_loss(x, torch.from_numpy(t_x), torch.from_numpy(t_y))
    loss.sum().backward()
    assert torch.isfinite(loss).all() and torch.isfinite(x.grad).all()


def test_gradient_keeps_the_input_dtype_and_layout():
    logp, t_x, t_y = ragged(3)
    x = torch.from_numpy(logp.astype(np.float64)).requires_grad_()
    forward_sum_loss(x, torch.from_numpy(t_x),
                     torch.from_numpy(t_y)).sum().backward()
    assert x.grad.dtype == torch.float64 and x.grad.shape == x.shape


def test_cpu_route_launches_no_kernel():
    _build.reset_kernel_launches()
    logp, t_x, t_y = ragged(4)
    x = torch.from_numpy(logp).requires_grad_()
    forward_sum_loss(x, torch.from_numpy(t_x),
                     torch.from_numpy(t_y)).sum().backward()
    forward_sum_loss_with_posteriors(torch.from_numpy(logp),
                                     torch.from_numpy(t_x),
                                     torch.from_numpy(t_y))
    assert _build.kernel_launches() == {}


def test_forward_sum_grad_checks_its_inputs():
    lp = torch.zeros((5, 2, 3))
    lengths = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        forward_sum_grad(lp.to("meta"), lp.to("meta"), torch.zeros(2),
                         lengths, lengths)
    with pytest.raises(ValueError, match="alphas"):
        forward_sum_grad(lp, lp[:4], torch.zeros(2), lengths, lengths)
    with pytest.raises(ValueError, match="total"):
        forward_sum_grad(lp, lp, torch.zeros(3), lengths, lengths)
    with pytest.raises(ValueError, match="t_x"):
        forward_sum_grad(lp, lp, torch.zeros(2), torch.ones(3), lengths)
    assert forward_sum_kernel.forward_sum_grad(
        lp[:0], lp[:0], torch.zeros(2), lengths, lengths).shape == (0, 2, 3)
