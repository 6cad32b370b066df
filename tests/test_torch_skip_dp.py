"""aligner_tpu_torch skip-state (implicit-pause) DPs against the JAX
package (CPU route): the plain versions of kernels H4, H5 and H6 against
the numpy oracles, the lax scans and the Pallas bodies in interpret mode.

The Pallas reference is the per-frame form (`pair=False`); the pair form
that `pair=None` picks at these sizes is documented there as a tolerance
contract, not a bit contract. Paths are compared bit for bit; alphas,
posteriors, losses and gradients at rtol 1e-5 / atol 1e-6 (float32 sweeps
whose exp and log1p come from two libraries)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aligner_tpu.ops import skip_dp as jax_skip
from aligner_tpu.ops import skip_dp_pallas as jax_pallas
from aligner_tpu_torch import _build
from aligner_tpu_torch.ops import skip_dp, skip_dp_kernel, skip_dp_reference
from aligner_tpu_torch.ops.forward_sum import _masked_logp
from aligner_tpu_torch.ops.skip_dp_kernel import (NEG, alpha_skip_plain,
                                                  gamma_skip_plain,
                                                  mas_skip_plain)

RTOL, ATOL = 1e-5, 1e-6


def t(a):
    return torch.from_numpy(np.asarray(a))


# --------------------------------------------------------------------------
# H4's plain version: the pause-aware Viterbi
# --------------------------------------------------------------------------

def viterbi_ragged(seed, B=4, T_x=6, T_y=24):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((B, 2 * T_x + 1, T_y)).astype(np.float32)
    t_x = rng.integers(1, T_x + 1, B).astype(np.int32)
    t_y = np.maximum(rng.integers(2, T_y + 1, B), t_x).astype(np.int32)
    return v, t_x, t_y


def viterbi_edges():
    """t_x = 1; t_x = t_y (every frame a token); t_y = 1; a full item."""
    v, t_x, t_y = viterbi_ragged(11, B=4, T_x=5, T_y=16)
    t_x[:] = [1, 5, 1, 5]
    t_y[:] = [9, 5, 1, 16]
    return v, t_x, t_y


def viterbi_ties():
    """All-zero and constant lattices: every comparison is a tie."""
    v = np.zeros((3, 9, 16), np.float32)
    v[2] = 0.5
    return v, np.array([4, 4, 2], np.int32), np.array([9, 16, 16], np.int32)


def viterbi_invalid():
    """t_x > t_y and t_x = 0 beside valid items."""
    v, t_x, t_y = viterbi_ragged(12, B=4, T_x=4, T_y=12)
    t_x[:] = [4, 0, 3, 2]
    t_y[:] = [3, 8, 12, 7]
    return v, t_x, t_y


def viterbi_long():
    """t_x > 63: the state index leaves int8's range."""
    rng = np.random.default_rng(13)
    v = rng.standard_normal((2, 2 * 70 + 1, 160)).astype(np.float32)
    return v, np.array([70, 66], np.int32), np.array([160, 131], np.int32)


VITERBI_CASES = {"seed0": lambda: viterbi_ragged(0),
                 "seed1": lambda: viterbi_ragged(1), "edges": viterbi_edges,
                 "ties": viterbi_ties, "invalid": viterbi_invalid,
                 "long": viterbi_long}


@pytest.mark.parametrize("cost", [0.0, -1.2, 0.6])
@pytest.mark.parametrize("case", sorted(VITERBI_CASES))
def test_mas_skip_plain_is_bit_identical(case, cost):
    """Against the numpy oracle, mas_skip_lax and (at the small sizes)
    the per-frame Pallas bodies in interpret mode."""
    v, t_x, t_y = VITERBI_CASES[case]()
    got = mas_skip_plain(t(v), t(t_x), t(t_y), enter_cost=cost).numpy()
    assert got.dtype == np.float32 and got.shape == v.shape
    jargs = (jnp.asarray(v), jnp.asarray(t_x), jnp.asarray(t_y))
    np.testing.assert_array_equal(
        got, np.asarray(jax_skip.mas_skip_lax(*jargs, enter_cost=cost)))
    if case != "long":
        np.testing.assert_array_equal(got, np.asarray(
            jax_pallas.mas_skip_pallas(*jargs, interpret=True, pair=False,
                                       enter_cost=cost)))
    for i in range(len(t_x)):
        if 1 <= t_x[i] <= t_y[i]:
            for oracle in (jax_skip.mas_skip_single,
                           skip_dp_reference.mas_skip_single):
                np.testing.assert_array_equal(
                    got[i], oracle(v[i].copy(), int(t_x[i]), int(t_y[i]),
                                   enter_cost=cost), err_msg=f"item {i}")
            assert (got[i, :, :t_y[i]].sum(0) == 1).all()
        else:
            assert not got[i].any()


def test_mas_skip_path_layouts_and_oversize_items():
    v, t_x, t_y = viterbi_ragged(3)
    want = mas_skip_plain(t(v), t(t_x), t(t_y), enter_cost=-0.4)
    fm = skip_dp.mas_skip_path_frame_major(
        t(v).transpose(1, 2).contiguous(), t(t_x), t(t_y), enter_cost=-0.4)
    assert fm.is_contiguous()
    torch.testing.assert_close(fm, want.transpose(1, 2), rtol=0, atol=0)
    torch.testing.assert_close(
        skip_dp_kernel.mas_skip_path(t(v), t(t_x), t(t_y), enter_cost=-0.4),
        want, rtol=0, atol=0)
    # 2*t_x+1 beyond the lattice's state axis: an all-zero path
    t_x[0], t_y[0] = 7, 24
    path = skip_dp_kernel.mas_skip_path(t(v), t(t_x), t(t_y))
    assert not path[0].any() and path[1:].any()
    with pytest.raises(ValueError, match="state rows"):
        skip_dp_reference.mas_skip_single(v[0], 7, 24)


def test_oracle_copy_matches_jax_oracle():
    rng = np.random.default_rng(5)
    lp = np.log(rng.dirichlet(np.ones(9), 12).T).astype(np.float32)
    for cost in (0.0, -0.7):
        assert skip_dp_reference.forward_sum_skip_numpy(lp, 4, 12, cost) \
            == jax_skip.forward_sum_skip_numpy(lp, 4, 12, cost)
    assert skip_dp.n_states(5) == jax_skip.n_states(5) == 11


# --------------------------------------------------------------------------
# H5's and H6's plain versions: the skip forward-sum sweeps
# --------------------------------------------------------------------------

def log_softmax(raw):
    return np.array(jax.nn.log_softmax(jnp.asarray(raw), axis=-1))


def fs_ragged(seed, B=3, T_x=5, T_y=16):
    rng = np.random.default_rng(seed)
    logp = log_softmax(rng.standard_normal(
        (B, T_y, 2 * T_x + 1)).astype(np.float32))
    t_x = rng.integers(1, T_x + 1, B).astype(np.int32)
    t_y = np.maximum(rng.integers(4, T_y + 1, B), t_x).astype(np.int32)
    return logp, t_x, t_y


def fs_edges():
    """t_y = 1 (t_x = 1); t_x = t_y; a full item."""
    logp, t_x, t_y = fs_ragged(21, B=3, T_x=4, T_y=12)
    t_x[:] = [1, 4, 4]
    t_y[:] = [1, 4, 12]
    return logp, t_x, t_y


def fs_invalid():
    logp, t_x, t_y = fs_ragged(22, B=3, T_x=4, T_y=12)
    t_x[:] = [4, 0, 3]
    t_y[:] = [3, 9, 12]
    return logp, t_x, t_y


def fs_neg_inf():
    """-inf at states past 2*t_x+1 and at a few live cells."""
    logp, t_x, t_y = fs_ragged(23, B=3, T_x=4, T_y=14)
    ss = np.arange(logp.shape[2])[None, None, :]
    logp = np.where(ss < (2 * t_x + 1)[:, None, None], logp, -np.inf)
    logp[0, 3, 1] = -np.inf
    logp[2, :, 4] = -np.inf
    return logp.astype(np.float32), t_x, t_y


def fs_dead_frame():
    """A frame whose every state is NEG: zero path mass."""
    logp, t_x, t_y = fs_ragged(24, B=2, T_x=4, T_y=12)
    t_x[:], t_y[:] = [3, 4], [12, 10]
    logp[:, 5, :] = NEG
    return logp, t_x, t_y


FS_CASES = {"seed0": lambda: fs_ragged(0), "seed1": lambda: fs_ragged(1),
            "edges": fs_edges, "invalid": fs_invalid, "neg_inf": fs_neg_inf,
            "dead_frame": fs_dead_frame}
# On a zero-mass item the posterior is 0/0 and the JAX package's lax
# route (masked by range) and its Pallas body (masked by liveness) give
# different finite values; the port follows the Pallas body.
NORMAL = sorted(set(FS_CASES) - {"dead_frame"})


def sweep_inputs(logp, t_x, t_y, cost):
    """(lp_tm, alphas, total) as the loss hands them to the beta sweep."""
    tx, ty = t(t_x), t(t_y)
    lp_tm = _masked_logp(t(logp), skip_dp.n_states(tx)).transpose(0, 1)
    alphas = alpha_skip_plain(lp_tm, ty, cost)
    valid = skip_dp._valid_items_skip(tx, ty, logp.shape[2])
    total = torch.where(valid,
                        skip_dp._total_from_alphas_skip(alphas[-1], tx), 0.0)
    return lp_tm, alphas, total


@pytest.mark.parametrize("cost", [0.0, -1.3])
@pytest.mark.parametrize("case", sorted(FS_CASES))
def test_alpha_skip_plain_matches_jax(case, cost):
    logp, t_x, t_y = FS_CASES[case]()
    lp_tm, alphas, total = sweep_inputs(logp, t_x, t_y, cost)
    jlp = jnp.asarray(lp_tm.contiguous().numpy())
    np.testing.assert_array_equal(np.asarray(jlp), np.moveaxis(np.asarray(
        jax_skip._masked_logp_skip(jnp.asarray(logp), jnp.asarray(t_x))),
        0, 1))
    for want in (jax_skip._alpha_scan_skip(jlp, jnp.asarray(t_y), cost),
                 jax_pallas.forward_sum_skip_alpha_pallas(
                     jlp, jnp.asarray(t_y), interpret=True, pair=False,
                     enter_cost=cost)):
        np.testing.assert_allclose(alphas.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
    jtotal = jax_skip._total_from_alphas_skip(
        jnp.asarray(alphas.numpy()), jnp.asarray(t_x))
    valid = (t_x >= 1) & (t_x <= t_y)
    np.testing.assert_allclose(total.numpy()[valid],
                               np.asarray(jtotal)[valid], rtol=RTOL)


@pytest.mark.parametrize("cost", [0.0, -1.3])
@pytest.mark.parametrize("case", sorted(FS_CASES))
def test_gamma_skip_plain_matches_pallas_kernel(case, cost):
    logp, t_x, t_y = FS_CASES[case]()
    lp_tm, alphas, total = sweep_inputs(logp, t_x, t_y, cost)
    got = gamma_skip_plain(lp_tm, alphas, total, t(t_x), t(t_y), cost)
    want = jax_pallas.forward_sum_skip_gamma_pallas(
        jnp.asarray(lp_tm.contiguous().numpy()), jnp.asarray(alphas.numpy()),
        jnp.asarray(total.numpy()), jnp.asarray(t_x), jnp.asarray(t_y),
        interpret=True, enter_cost=cost)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    live = ((np.arange(lp_tm.shape[0])[:, None, None] < t_y[None, :, None])
            & (lp_tm.numpy() > 0.5 * NEG))
    assert (got.numpy()[~live] == 0).all()


@pytest.mark.parametrize("cost", [0.0, 0.8])
@pytest.mark.parametrize("case", ["seed0", "seed1", "edges", "neg_inf"])
def test_gamma_skip_plain_matches_lax_beta_scan(case, cost):
    """Against exp(alpha + beta - total) from the lax scans; the
    per-frame occupancy sums to 1."""
    logp, t_x, t_y = FS_CASES[case]()
    lp_tm, alphas, total = sweep_inputs(logp, t_x, t_y, cost)
    got = gamma_skip_plain(lp_tm, alphas, total, t(t_x), t(t_y),
                           cost).numpy()
    jlp = jnp.asarray(lp_tm.contiguous().numpy())
    jal = jax_skip._alpha_scan_skip(jlp, jnp.asarray(t_y), cost)
    betas = jax_skip._beta_scan_skip(jlp, jnp.asarray(t_x),
                                     jnp.asarray(t_y), cost)
    jtot = jax_skip._total_from_alphas_skip(jal, jnp.asarray(t_x))
    want = np.exp(np.asarray(jal) + np.asarray(betas)
                  - np.asarray(jtot)[None, :, None])
    T_y, _, T_s = lp_tm.shape
    in_range = ((np.arange(T_y)[:, None, None] < t_y[None, :, None])
                & (np.arange(T_s)[None, None, :]
                   < (2 * t_x + 1)[None, :, None]))
    np.testing.assert_allclose(got, np.where(in_range, want, 0.0),
                               rtol=1e-4, atol=1e-5)
    for b in range(len(t_x)):
        np.testing.assert_allclose(got.sum(-1)[:t_y[b], b], 1.0, rtol=1e-4)


@pytest.mark.parametrize("cost", [0.0, -1.5, 0.8])
@pytest.mark.parametrize("case", NORMAL)
def test_loss_and_gradient_match_jax_grad(case, cost):
    logp, t_x, t_y = FS_CASES[case]()
    weights = np.random.default_rng(5).uniform(
        0.5, 2.0, len(t_x)).astype(np.float32)
    x = t(logp).requires_grad_()
    loss = skip_dp.forward_sum_skip_loss(x, t(t_x), t(t_y), enter_cost=cost)
    (loss * t(weights)).sum().backward()
    want_loss, want_grad = jax.value_and_grad(
        lambda lp: (jax_skip.forward_sum_skip_loss(
            lp, jnp.asarray(t_x), jnp.asarray(t_y), enter_cost=cost)
            * weights).sum())(jnp.asarray(logp))
    assert torch.isfinite(x.grad).all()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float((loss.detach().numpy() * weights).sum()),
                               float(want_loss), rtol=RTOL)
    valid = (t_x >= 1) & (t_x <= t_y)
    assert (x.grad.numpy()[~valid] == 0).all()
    assert (loss.detach().numpy()[~valid] == 0).all()


@pytest.mark.parametrize("cost", [0.0, -0.9])
def test_loss_matches_the_numpy_marginal(cost):
    logp, t_x, t_y = fs_ragged(7, B=4, T_x=4, T_y=10)
    loss = skip_dp.forward_sum_skip_loss(t(logp), t(t_x), t(t_y),
                                         enter_cost=cost).numpy()
    for i in range(len(t_x)):
        want = skip_dp_reference.forward_sum_skip_numpy(
            logp[i].T, int(t_x[i]), int(t_y[i]), enter_cost=cost)
        np.testing.assert_allclose(loss[i], -want, rtol=RTOL)


def test_dead_frame_gradient_is_finite_and_oversize_items_are_invalid():
    logp, t_x, t_y = fs_dead_frame()
    x = t(logp).requires_grad_()
    loss = skip_dp.forward_sum_skip_loss(x, t(t_x), t(t_y))
    loss.sum().backward()
    assert torch.isfinite(loss).all() and torch.isfinite(x.grad).all()
    # 0/0 posteriors: the JAX package's lax route gives other finite
    # values than its Pallas body, which the port follows (held to it in
    # test_gamma_skip_plain_matches_pallas_kernel[dead_frame-*])
    lax_grad = jax.grad(lambda lp: jax_skip.forward_sum_skip_loss(
        lp, jnp.asarray(t_x), jnp.asarray(t_y)).sum())(jnp.asarray(logp))
    assert np.isfinite(np.asarray(lax_grad)).all()
    assert np.abs(x.grad.numpy() - np.asarray(lax_grad)).max() > 0.5
    # more states than the lattice holds: loss 0, gradient 0
    logp, t_x, t_y = fs_ragged(8)
    t_x[1], t_y[1] = 6, 16
    x = t(logp).requires_grad_()
    loss = skip_dp.forward_sum_skip_loss(x, t(t_x), t(t_y))
    loss.sum().backward()
    assert loss[1] == 0 and not x.grad[1].any() and x.grad[0].any()


@pytest.mark.parametrize("case", ["seed0", "invalid", "neg_inf"])
def test_skip_posteriors_match_jax(case):
    logp, t_x, t_y = FS_CASES[case]()
    gamma, total = skip_dp.skip_posteriors(t(logp), t(t_x), t(t_y))
    jgamma, jtotal = jax_skip.skip_posteriors(
        jnp.asarray(logp), jnp.asarray(t_x), jnp.asarray(t_y))
    np.testing.assert_allclose(gamma.numpy(), np.asarray(jgamma), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(total.numpy(), np.asarray(jtotal), rtol=RTOL)


def test_gradient_keeps_the_input_dtype_and_layout():
    logp, t_x, t_y = fs_ragged(3)
    x = t(logp.astype(np.float64)).requires_grad_()
    skip_dp.forward_sum_skip_loss(x, t(t_x), t(t_y)).sum().backward()
    assert x.grad.dtype == torch.float64 and x.grad.shape == x.shape


# --------------------------------------------------------------------------
# State-axis helpers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["inherit", "bridge"])
def test_expand_prior_to_states_matches_jax(mode):
    rng = np.random.default_rng(9)
    prior = np.log(rng.dirichlet(np.ones(6), (3, 10))).astype(np.float32)
    t_x = np.array([6, 3, 1], np.int32)
    prior[1, :, 3:] = NEG
    got = skip_dp.expand_prior_to_states(t(prior), t(t_x), mode=mode)
    want = jax_skip.expand_prior_to_states(jnp.asarray(prior),
                                           jnp.asarray(t_x), mode=mode)
    assert got.shape == (3, 10, 13)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    with pytest.raises(ValueError, match="pause-prior mode"):
        skip_dp.expand_prior_to_states(t(prior), t(t_x), mode="flat")


def test_token_expansion_and_duration_split_match_jax():
    tokens = np.array([[7, 8, 9], [4, 5, 0]], np.int32)
    lengths = np.array([3, 2], np.int32)
    np.testing.assert_array_equal(
        skip_dp.expand_tokens_with_pauses(t(tokens), t(lengths), 99).numpy(),
        np.asarray(jax_skip.expand_tokens_with_pauses(
            jnp.asarray(tokens), jnp.asarray(lengths), 99)))
    sd = np.arange(14, dtype=np.float32).reshape(2, 7)
    tok, pause = skip_dp.split_state_durations(t(sd))
    jtok, jpause = jax_skip.split_state_durations(jnp.asarray(sd))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(pause.numpy(), np.asarray(jpause))


# --------------------------------------------------------------------------
# Routing and input checks
# --------------------------------------------------------------------------

def test_cpu_route_launches_no_kernel():
    _build.reset_kernel_launches()
    logp, t_x, t_y = fs_ragged(4)
    x = t(logp).requires_grad_()
    skip_dp.forward_sum_skip_loss(x, t(t_x), t(t_y)).sum().backward()
    skip_dp.skip_posteriors(t(logp), t(t_x), t(t_y))
    skip_dp.mas_skip_path_frame_major(t(logp), t(t_x), t(t_y))
    assert _build.kernel_launches() == {}


def test_wrappers_check_their_inputs():
    lp = torch.zeros((5, 2, 7))
    lengths = torch.ones(2, dtype=torch.int32)
    meta = lp.to("meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        skip_dp_kernel.mas_skip_path(meta, torch.ones(5), torch.ones(5))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        skip_dp_kernel.forward_sum_skip_alpha(meta, lengths)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        skip_dp_kernel.forward_sum_skip_grad(meta, meta, torch.zeros(2),
                                             lengths, lengths)
    with pytest.raises(TypeError, match="float32"):
        skip_dp_kernel.mas_skip_path(lp.double(), torch.ones(5), torch.ones(5))
    with pytest.raises(ValueError, match="t_y"):
        skip_dp_kernel.forward_sum_skip_alpha(lp, torch.ones(3))
    with pytest.raises(ValueError, match="alphas"):
        skip_dp_kernel.forward_sum_skip_grad(lp, lp[:4], torch.zeros(2),
                                             lengths, lengths)
    with pytest.raises(ValueError, match="total"):
        skip_dp_kernel.forward_sum_skip_grad(lp, lp, torch.zeros(3), lengths,
                                             lengths)
    alphas, final = skip_dp_kernel.forward_sum_skip_alpha(lp[:0], lengths)
    assert alphas.shape == (0, 2, 7) and final.shape == (2, 7)
    assert skip_dp_kernel.mas_skip_path(lp[:, :, :0], torch.ones(5),
                                        torch.ones(5)).shape == (5, 2, 0)
