"""The port's small lattice ops against aligner_tpu on the same seeded
inputs: `alignment_posteriors` (over the forward-sum sweeps H2 and H3,
their plain versions on the CPU), `ops/durations.py` and
`ops/regularizers.py`, at the tolerances of tests/test_data_durations.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aligner_tpu.ops import alignment_posteriors as jax_posteriors
from aligner_tpu.ops import durations as jdur
from aligner_tpu.ops import regularizers as jreg
from aligner_tpu_torch.ops import alignment_posteriors
from aligner_tpu_torch.ops import durations as tdur
from aligner_tpu_torch.ops import regularizers as treg

# JAX's alignment_posteriors takes gamma = exp(alpha + beta - total) from
# its lax scans; the port's comes from the posterior sweep of H3's plain
# version, so gamma (a probability) differs by float32 rounding: rtol 1e-5
# with atol 1e-5. JAX differentiates total by autodiff through the scans,
# a third computation of gamma; the gradient is held as gamma_plain is
# against the lax scans in tests/test_torch_forward_sum_grad.py.
POST_RTOL, POST_ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def lattice(seed, B, T_x, T_y):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T_y, T_x)).astype(np.float32) * 2
    lp = np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    t_x = rng.integers(1, T_x + 1, B).astype(np.int32)
    t_y = np.maximum(rng.integers(1, T_y + 1, B), t_x).astype(np.int32)
    t_x[0], t_y[0] = T_x, T_y          # a full item
    if B > 2:
        t_x[1], t_y[1] = 1, T_y // 2   # one token
        t_y[2] = t_x[2]                # one frame a token
    return lp, t_x, t_y


SHAPES = [(4, 8, 30), (6, 17, 64), (3, 1, 5)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("B,T_x,T_y", SHAPES)
def test_alignment_posteriors_match_jax(seed, B, T_x, T_y):
    lp, t_x, t_y = lattice(seed, B, T_x, T_y)
    want_gamma, want_total = jax_posteriors(
        jnp.asarray(lp), jnp.asarray(t_x), jnp.asarray(t_y))
    gamma, total = alignment_posteriors(
        torch.from_numpy(lp), torch.from_numpy(t_x), torch.from_numpy(t_y))
    assert gamma.shape == (B, T_y, T_x) and gamma.dtype == torch.float32
    np.testing.assert_allclose(gamma.numpy(), np.asarray(want_gamma),
                               rtol=POST_RTOL, atol=POST_ATOL)
    np.testing.assert_allclose(total.numpy(), np.asarray(want_total),
                               rtol=POST_RTOL)
    # rows sum to one over the text on real frames (to the float32
    # rounding of T_x exponentials), zero elsewhere
    rows = gamma.sum(-1).numpy()
    frames = np.arange(T_y)[None, :] < t_y[:, None]
    np.testing.assert_allclose(rows[frames], 1.0, rtol=1e-4)
    assert (rows[~frames] == 0).all()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("B,T_x,T_y", SHAPES)
def test_total_gradient_matches_jax_grad(seed, B, T_x, T_y):
    lp, t_x, t_y = lattice(seed, B, T_x, T_y)
    w = np.random.default_rng(seed + 7).standard_normal(B).astype(np.float32)

    def jax_total(x):
        return jnp.sum(jax_posteriors(x, jnp.asarray(t_x),
                                      jnp.asarray(t_y))[1] * w)

    want = np.asarray(jax.grad(jax_total)(jnp.asarray(lp)))
    x = torch.tensor(lp, requires_grad=True)
    _, total = alignment_posteriors(x, torch.from_numpy(t_x),
                                    torch.from_numpy(t_y))
    (total * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


def test_gradient_through_gamma_raises():
    """A deliberate difference (ROADMAP Queue 3): only `total` is
    differentiable; JAX differentiates gamma too, by autodiff over its
    lax scans, which needs a second-order sweep here."""
    lp, t_x, t_y = lattice(0, 4, 8, 30)
    x = torch.tensor(lp, requires_grad=True)
    gamma, total = alignment_posteriors(x, torch.from_numpy(t_x),
                                        torch.from_numpy(t_y))
    with pytest.raises(RuntimeError, match="second-order"):
        (gamma.sum() + total.sum()).backward()
    with torch.no_grad():
        gamma, _ = alignment_posteriors(x, torch.from_numpy(t_x),
                                        torch.from_numpy(t_y))
    assert not gamma.requires_grad


def test_invalid_items_get_zero_posteriors_and_total():
    lp, t_x, t_y = lattice(2, 4, 8, 30)
    t_x[3], t_y[3] = 9, 5           # more tokens than frames
    t_x[2], t_y[2] = 0, 10          # no tokens
    x = torch.tensor(lp, requires_grad=True)
    gamma, total = alignment_posteriors(x, torch.from_numpy(t_x),
                                        torch.from_numpy(t_y))
    assert (gamma[2:] == 0).all() and (total[2:] == 0).all()
    total.sum().backward()
    assert (x.grad[2:] == 0).all()
    assert torch.isfinite(x.grad).all()


DURS = np.array([[2, 3, 1, 0], [4, 0, 0, 0], [1, 1, 1, 5]], np.int32)


@pytest.mark.parametrize("mel_lengths", [None, [6, 3, 7]])
@pytest.mark.parametrize("max_mel", [8, 10])
def test_path_duration_roundtrip_matches_jax(max_mel, mel_lengths):
    ml_j = None if mel_lengths is None else jnp.asarray(mel_lengths)
    ml_t = None if mel_lengths is None else torch.tensor(mel_lengths)
    want = np.asarray(jdur.path_from_durations(jnp.asarray(DURS), max_mel,
                                               ml_j))
    path = tdur.path_from_durations(torch.from_numpy(DURS), max_mel, ml_t)
    assert path.dtype == torch.float32
    np.testing.assert_array_equal(path.numpy(), want)
    for frame_major in (False, True):
        p = path.transpose(1, 2) if frame_major else path
        pj = jnp.swapaxes(jnp.asarray(want), 1, 2) if frame_major else \
            jnp.asarray(want)
        np.testing.assert_array_equal(
            tdur.durations_from_path(p, frame_major=frame_major).numpy(),
            np.asarray(jdur.durations_from_path(pj,
                                                frame_major=frame_major)))


def test_path_from_durations_keeps_both_signatures():
    """ops/durations.py has the JAX signature; the MAS durations mode's
    expansion in ops/mas_kernel.py keeps its own beside it."""
    from aligner_tpu_torch.ops.mas_kernel import \
        path_from_durations as mas_durations_path
    durs = torch.from_numpy(DURS)
    np.testing.assert_array_equal(
        mas_durations_path(durs, 8).numpy(),
        tdur.path_from_durations(durs, 8).numpy())
    with pytest.raises(TypeError):
        mas_durations_path(durs, 8, torch.tensor([6, 3, 7]))


def test_duration_loss_and_inverse_match_jax():
    rng = np.random.default_rng(4)
    pred = rng.standard_normal((3, 4)).astype(np.float32)
    durs = DURS.astype(np.float32)
    tl = np.array([3, 1, 4], np.int32)
    want = float(jdur.duration_loss(jnp.asarray(pred), jnp.asarray(durs),
                                    jnp.asarray(tl)))
    got = tdur.duration_loss(torch.from_numpy(pred), torch.from_numpy(durs),
                             torch.from_numpy(tl))
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    # a perfect predictor's output inverts to its targets
    target = np.log(durs + 1e-6)
    for lengths in (None, tl):
        want = np.asarray(jdur.durations_from_log(
            jnp.asarray(target),
            None if lengths is None else jnp.asarray(lengths)))
        got = tdur.durations_from_log(
            torch.from_numpy(target),
            None if lengths is None else torch.from_numpy(lengths))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    # half-way values round to even, as jnp.round does
    halves = np.log(np.array([[0.5, 1.5, 2.5, 3.5]], np.float32))
    np.testing.assert_array_equal(
        tdur.durations_from_log(torch.from_numpy(halves),
                                min_duration=0).numpy(),
        np.asarray(jdur.durations_from_log(jnp.asarray(halves),
                                           min_duration=0)))


def test_selected_loglik_matches_jax():
    rng = np.random.default_rng(6)
    value = rng.standard_normal((3, 4, 10)).astype(np.float32)
    path = np.array(jdur.path_from_durations(jnp.asarray(DURS), 10))
    want = np.asarray(jdur.selected_loglik(jnp.asarray(value),
                                           jnp.asarray(path)))
    v = torch.tensor(value, requires_grad=True)
    got = tdur.selected_loglik(v, torch.from_numpy(path))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5)
    got.sum().backward()
    np.testing.assert_array_equal(v.grad.numpy(), path)


def attention(seed, B=3, T_y=12, T_x=6):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T_y, T_x)).astype(np.float32) * 3
    return np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("slack", [0.0, 0.3])
@pytest.mark.parametrize("text_lengths", [None, [6, 4, 1]])
def test_regularizers_match_jax(seed, slack, text_lengths):
    attn = attention(seed)
    ml = np.array([12, 9, 2], np.int32)
    tl_j = None if text_lengths is None else jnp.asarray(text_lengths)
    tl_t = None if text_lengths is None else torch.tensor(text_lengths)
    np.testing.assert_allclose(
        treg.attention_centroids(torch.from_numpy(attn), tl_t).numpy(),
        np.asarray(jreg.attention_centroids(jnp.asarray(attn), tl_j)),
        rtol=1e-5, atol=1e-6)

    def jax_loss(a):
        return jreg.monotonic_attention_loss(a, jnp.asarray(ml), tl_j,
                                             slack=slack)

    want, want_grad = jax.value_and_grad(jax_loss)(jnp.asarray(attn))
    a = torch.tensor(attn, requires_grad=True)
    got = treg.monotonic_attention_loss(a, torch.from_numpy(ml), tl_t,
                                        slack=slack)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-5, atol=1e-6)


def test_monotonic_loss_is_zero_on_a_monotone_path():
    mono = np.zeros((2, 12, 6), np.float32)
    for t in range(12):
        mono[:, t, min(t // 2, 5)] = 1.0
    ml = torch.tensor([12, 9])
    assert float(treg.monotonic_attention_loss(torch.from_numpy(mono),
                                               ml)) == 0.0
    rev = torch.from_numpy(mono[:, ::-1].copy())
    assert float(treg.monotonic_attention_loss(rev, ml)) > 0.2
