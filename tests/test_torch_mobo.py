"""aligner_tpu_torch MoBo ops against the JAX package on the CPU: the
plain versions of kernels H7, H8 and H9 against the lax scans and against
the Pallas kernels in interpret mode, `mobo_forward`, `mobo_loss` and
their gradients against `jax.grad`, and `mobo_hard_boundaries` against
the JAX function and a brute-force enumeration."""
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aligner_tpu.ops import mobo as jmobo
from aligner_tpu.ops.mobo_pallas import (mobo_alpha_pallas, mobo_beta_pallas,
                                         mobo_bp_pallas)
from aligner_tpu_torch.ops import mobo, mobo_kernel

NEG = mobo_kernel.NEG

# name: B, T_x, T_y, D, t_x, t_y (one shape for most, so that the JAX side
# compiles once)
SWEEP_CASES = {
    "ragged": (4, 9, 30, 4, [9, 7, 3, 8], [30, 25, 12, 17]),
    # t_y = t_x * D: every token takes the whole window
    "tight": (4, 9, 30, 4, [7, 4, 2, 1], [28, 16, 8, 4]),
    # item 1 has t_y > t_x * D (no boundary sequence), item 2 t_x = 0,
    # item 3 t_x = 1 with a window wider than its frames
    "infeasible": (4, 9, 30, 4, [8, 3, 0, 1], [20, 26, 9, 3]),
    # the end position is the last of the grid, on an odd T_x
    "full": (4, 9, 30, 4, [9, 8, 9, 2], [30, 30, 9, 5]),
    # another shape: an even T_x, a wider window than some t_y
    "wide_window": (3, 12, 40, 6, [12, 12, 2], [40, 33, 5]),
}


def make_case(name, seed=0):
    B, T_x, T_y, D, t_x, t_y = SWEEP_CASES[name]
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((B, T_y, T_x)).astype(np.float32)
    return e, np.array(t_x, np.int32), np.array(t_y, np.int32), D


def feasible(t_x, t_y, D):
    return (t_x >= 1) & (t_x <= t_y) & (t_y <= t_x * D)


def check_live(got, want):
    """Live cells rtol 1e-6 / atol 1e-5 (the JAX package's own limits
    between its kernels and its scans); dead cells below NEG / 2."""
    got, want = np.asarray(got), np.asarray(want)
    live = want > 0.5 * NEG
    np.testing.assert_allclose(got[live], want[live], rtol=1e-6, atol=1e-5)
    assert (got[~live] <= 0.5 * NEG).all()


@pytest.mark.parametrize("name", sorted(SWEEP_CASES))
def test_plain_sweeps_match_scans_and_pallas(name):
    e, t_x, t_y, D = make_case(name)
    jtx, jty = jnp.asarray(t_x), jnp.asarray(t_y)
    ttx, tty = torch.from_numpy(t_x), torch.from_numpy(t_y)
    je_tm = jmobo._prep_energies(jnp.asarray(e), jtx, jty)
    e_tm = mobo._prep_energies(torch.from_numpy(e), ttx, tty)
    np.testing.assert_array_equal(e_tm.numpy(), np.asarray(je_tm))

    logB = mobo_kernel.mobo_alpha_plain(e_tm, ttx, D)
    check_live(logB, jmobo._boundary_scan(je_tm, jtx, jty, D, False)[0])
    check_live(logB, mobo_alpha_pallas(je_tm, jtx, D, interpret=True))
    betas = mobo_kernel.mobo_beta_plain(e_tm, ttx, tty, D)
    check_live(betas, jmobo._beta_scan(je_tm, jtx, jty, D))
    check_live(betas, mobo_beta_pallas(je_tm, jtx, jty, D, interpret=True))

    bp, _ = mobo_kernel.mobo_bp_plain(e_tm, ttx, tty, D)
    scan_bp = np.asarray(jmobo._boundary_scan(je_tm, jtx, jty, D, True)[1])
    pallas_bp = np.asarray(mobo_bp_pallas(je_tm, jtx, D, interpret=True))
    for i in range(len(t_x)):
        # backpointers mean something on live tokens only
        np.testing.assert_array_equal(bp.numpy()[:t_x[i], i],
                                      scan_bp[:t_x[i], i])
        assert not bp[t_x[i]:, i].any()
    # the Pallas kernel, like the port, emits 0 on frozen tokens
    np.testing.assert_array_equal(bp.numpy(), pallas_bp)
    # the wrappers take the plain versions on a CPU tensor
    assert torch.equal(mobo_kernel.mobo_alpha(e_tm, ttx, D), logB)
    assert torch.equal(mobo_kernel.mobo_beta(e_tm, ttx, tty, D), betas)
    assert torch.equal(mobo_kernel.mobo_bp(e_tm, ttx, tty, D)[0], bp)


def test_sweeps_read_the_grid_through_strides():
    e, t_x, t_y, D = make_case("ragged")
    ttx, tty = torch.from_numpy(t_x), torch.from_numpy(t_y)
    e_tm = mobo._prep_energies(torch.from_numpy(e), ttx, tty)
    view = e_tm.permute(1, 2, 0).contiguous().permute(2, 0, 1)
    assert not view.is_contiguous()
    assert torch.equal(mobo_kernel.mobo_alpha(view, ttx, D),
                       mobo_kernel.mobo_alpha(e_tm, ttx, D))


@pytest.mark.parametrize("bad", ["dtype", "ndim", "lengths", "window",
                                 "device"])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad):
    e_tm = torch.zeros((3, 2, 5))
    t = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        if bad == "dtype":
            mobo_kernel.mobo_alpha(e_tm.double(), t, 2)
        elif bad == "ndim":
            mobo_kernel.mobo_beta(e_tm[0], t, t, 2)
        elif bad == "lengths":
            mobo_kernel.mobo_bp(e_tm, t, torch.ones(3), 2)
        elif bad == "window":
            mobo_kernel.mobo_alpha(e_tm, t, 0)
        else:
            mobo_kernel.mobo_alpha(e_tm.to("meta"), t, 2)


FORWARD_KEYS = ("loss", "log_boundaries", "soft_alignment",
                "expected_durations")


@pytest.mark.parametrize("name", sorted(SWEEP_CASES))
def test_mobo_forward_matches_jax(name):
    """rtol 1e-5 / atol 1e-5 on the items with a boundary sequence
    (log_boundaries on its live cells); the others' loss is the ~1e15
    sentinel on both sides."""
    e, t_x, t_y, D = make_case(name, seed=1)
    want = jmobo.mobo_forward(jnp.asarray(e), jnp.asarray(t_x),
                              jnp.asarray(t_y), D)
    got = mobo.mobo_forward(torch.from_numpy(e), torch.from_numpy(t_x),
                            torch.from_numpy(t_y), D)
    ok = feasible(t_x, t_y, D)
    for key in FORWARD_KEYS:
        g, w = got[key].numpy()[ok], np.asarray(want[key])[ok]
        assert got[key].shape == want[key].shape
        if key == "log_boundaries":
            live = w > 0.5 * NEG
            assert (g[~live] <= 0.5 * NEG).all()
            g, w = g[live], w[live]
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=key)
    assert (got["loss"].numpy()[~ok] > 1e14).all()
    assert (np.asarray(want["loss"])[~ok] > 1e14).all()


def weighted_scalars(B, T_x, T_y, seed):
    """Fixed random weights, so that every output entry gets a distinct
    cotangent (tests/test_mobo.py's scalar)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T_y, T_x)).astype(np.float32),
            rng.standard_normal((B, T_x)).astype(np.float32),
            rng.standard_normal((B, T_x, T_y)).astype(np.float32))


GRAD_CASES = {
    # the JAX test's own shape and lengths
    "jax_test": (3, 6, 14, 4, [6, 4, 2], [14, 10, 7]),
    "tight": (3, 6, 14, 4, [3, 2, 1], [12, 8, 4]),
    "single_token_grid": (2, 1, 5, 6, [1, 1], [5, 2]),
}


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_mobo_forward_gradient_matches_jax(name):
    """The analytic adjoint through all four outputs at once against
    jax.grad, rtol 1e-4 / atol 2e-5 (the JAX test's limits between its
    adjoint and autodiff)."""
    B, T_x, T_y, D, t_x, t_y = GRAD_CASES[name]
    rng = np.random.default_rng(37)
    e = rng.standard_normal((B, T_y, T_x)).astype(np.float32)
    t_x, t_y = np.array(t_x, np.int32), np.array(t_y, np.int32)
    w_g, w_d, w_p = weighted_scalars(B, T_x, T_y, 38)

    def jax_scalar(e):
        out = jmobo.mobo_forward(e, jnp.asarray(t_x), jnp.asarray(t_y), D)
        lb = jnp.where(out["log_boundaries"] > 0.5 * NEG,
                       out["log_boundaries"], 0.0)
        return (out["loss"].sum() + (w_g * out["soft_alignment"]).sum()
                + (w_d * out["expected_durations"]).sum() + (w_p * lb).sum())

    x = torch.from_numpy(e).requires_grad_()
    out = mobo.mobo_forward(x, torch.from_numpy(t_x), torch.from_numpy(t_y),
                            D)
    lb = torch.where(out["log_boundaries"] > 0.5 * NEG,
                     out["log_boundaries"], 0.0)
    scalar = (out["loss"].sum()
              + (torch.from_numpy(w_g) * out["soft_alignment"]).sum()
              + (torch.from_numpy(w_d) * out["expected_durations"]).sum()
              + (torch.from_numpy(w_p) * lb).sum())
    scalar.backward()
    np.testing.assert_allclose(scalar.item(),
                               float(jax_scalar(jnp.asarray(e))), rtol=1e-5)
    want = np.asarray(jax.grad(jax_scalar)(jnp.asarray(e)))
    assert np.isfinite(x.grad.numpy()).all()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-4, atol=2e-5)
    assert np.abs(want).max() > 1e-2


def test_mobo_forward_gradient_zero_on_padding():
    """Dead tokens and frames get exactly zero gradient from the adjoint
    (frozen and pass-through rows carry no cotangent)."""
    rng = np.random.default_rng(41)
    B, T_x, T_y, D = 2, 6, 14, 4
    x = torch.from_numpy(rng.standard_normal((B, T_y, T_x))
                         .astype(np.float32)).requires_grad_()
    out = mobo.mobo_forward(x, torch.tensor([4, 6]), torch.tensor([9, 14]), D)
    (out["loss"].sum() + out["soft_alignment"].sum()).backward()
    g = x.grad.numpy()
    assert (g[0, :, 4:] == 0).all()      # tokens >= t_x
    assert (g[0, 9:, :] == 0).all()      # frames >= t_y
    assert np.abs(g[0, :9, :4]).max() > 0


@pytest.mark.parametrize("name", ["ragged", "tight", "wide_window"])
def test_mobo_loss_and_gradient_match_jax(name):
    e, t_x, t_y, D = make_case(name, seed=2)
    jtx, jty = jnp.asarray(t_x), jnp.asarray(t_y)
    want, want_grad = jax.value_and_grad(
        lambda e: jmobo.mobo_loss(e, jtx, jty, D))(jnp.asarray(e))
    x = torch.from_numpy(e).requires_grad_()
    loss = mobo.mobo_loss(x, torch.from_numpy(t_x), torch.from_numpy(t_y), D)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-4, atol=2e-5)
    # per-token gradient rows sum to zero (posterior minus expected mass)
    np.testing.assert_allclose(x.grad.numpy().sum(axis=1), 0.0, atol=1e-5)


def test_log_marginal_honours_the_cotangent():
    e, t_x, t_y, D = make_case("ragged", seed=3)
    g = np.array([0.5, -2.0, 0.0, 1.5], np.float32)      # one per item
    want = jax.grad(lambda e: (jmobo.mobo_log_marginal(
        e, jnp.asarray(t_x), jnp.asarray(t_y), D) * g).sum())(jnp.asarray(e))
    x = torch.from_numpy(e).requires_grad_()
    (mobo.mobo_log_marginal(x, t_x, t_y, D) * torch.from_numpy(g)) \
        .sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-4,
                               atol=2e-5)
    assert not x.grad[2].any()


# ----- brute force (a copy of the JAX tests' enumeration) -----

def enumerate_boundaries(t_x, t_y, D):
    """All valid boundary tuples (b_0 < ... < b_{t_x-1} = t_y-1) with
    b_{-1} = -1 and b_i - b_{i-1} <= D."""
    seqs = []
    for mids in itertools.combinations(range(t_y - 1), t_x - 1):
        b = list(mids) + [t_y - 1]
        prev = -1
        ok = True
        for x in b:
            if x - prev > D or x - prev < 1:
                ok = False
                break
            prev = x
        if ok:
            seqs.append(tuple(b))
    return seqs


def brute_force(e, t_x, t_y, D):
    """e: [T_y, T_x] frame-major energies. Returns (log total, boundary
    posteriors dict, best seq)."""
    def log_w(i, t_prev, t):
        window = [e[t_prev + d, i] for d in range(1, D + 1)
                  if t_prev + d < t_y]
        return e[t, i] - np.logaddexp.reduce(window)

    seqs = enumerate_boundaries(t_x, t_y, D)
    assert seqs, "no valid boundary sequence for this shape"
    scores = []
    for b in seqs:
        prev, s = -1, 0.0
        for i, t in enumerate(b):
            s += log_w(i, prev, t)
            prev = t
        scores.append(s)
    total = np.logaddexp.reduce(scores)
    post = {}
    for b, s in zip(seqs, scores):
        for i, t in enumerate(b):
            post[(i, t)] = np.logaddexp(post.get((i, t), -np.inf), s - total)
    return total, post, seqs[int(np.argmax(scores))]


BRUTE_CASES = [(1, 1, 2, 0), (1, 3, 4, 1), (2, 4, 3, 2), (3, 6, 3, 3),
               (4, 8, 4, 4), (5, 7, 2, 5), (4, 9, 4, 11)]


@pytest.mark.parametrize("t_x,t_y,D,seed", BRUTE_CASES)
def test_against_brute_force(t_x, t_y, D, seed):
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((1, 9, 6)).astype(np.float32)
    lengths = torch.tensor([t_x]), torch.tensor([t_y])
    out = mobo.mobo_forward(torch.from_numpy(e), *lengths, D)
    total, post, best = brute_force(e[0], t_x, t_y, D)
    np.testing.assert_allclose(out["loss"][0].item(), -total, rtol=1e-4,
                               atol=1e-4)
    lb = out["log_boundaries"].numpy()[0]
    for (i, t), lp in post.items():
        np.testing.assert_allclose(lb[i, t], lp, rtol=1e-3, atol=1e-3)
    durs, path = mobo.mobo_hard_boundaries(torch.from_numpy(e), *lengths, D)
    want = np.diff([-1] + list(best))
    np.testing.assert_array_equal(durs.numpy()[0, :t_x], want)
    assert not durs[0, t_x:].any() and durs.dtype == torch.int32
    p = path.numpy()[0]
    np.testing.assert_allclose(p[:t_y].sum(-1), 1.0)
    np.testing.assert_array_equal(p.sum(0)[:t_x], want)
    assert not p[t_y:].any()


@pytest.mark.parametrize("name", sorted(SWEEP_CASES))
def test_hard_boundaries_match_jax(name):
    """Durations and path equal to the JAX function's; an item without a
    boundary sequence keeps its walk inside the grid (its durations mean
    nothing, and agree all the same while t_y >= t_x)."""
    e, t_x, t_y, D = make_case(name, seed=4)
    e = e * 3
    want_durs, want_path = jmobo.mobo_hard_boundaries(
        jnp.asarray(e), jnp.asarray(t_x), jnp.asarray(t_y), D)
    durs, path = mobo.mobo_hard_boundaries(
        torch.from_numpy(e), torch.from_numpy(t_x), torch.from_numpy(t_y), D)
    np.testing.assert_array_equal(durs.numpy(), np.asarray(want_durs))
    np.testing.assert_array_equal(path.numpy(), np.asarray(want_path))
    ok = feasible(t_x, t_y, D)
    d = durs.numpy()[ok]
    assert (d.sum(1) == t_y[ok]).all() and (d <= D).all()


def test_hard_boundaries_take_no_gradient_and_stay_in_the_grid():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 6, 8)).astype(np.float32)) \
        .requires_grad_()
    # more tokens than frames: the walk would leave the grid unclamped
    durs, path = mobo.mobo_hard_boundaries(x, torch.tensor([8, 3]),
                                           torch.tensor([5, 6]), 3)
    assert not durs.requires_grad and not path.requires_grad
    assert (durs >= 0).all() and (durs <= 3).all()
    assert durs[1].sum() == 6
