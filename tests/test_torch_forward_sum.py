"""aligner_tpu_torch forward-sum loss against the JAX package (CPU route,
the alpha kernel's plain version): loss at rtol 1e-5, invalid items 0,
-inf inputs finite. The backward is held to `jax.grad` in
test_torch_forward_sum_grad.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aligner_tpu.ops import forward_sum as jax_fs
from aligner_tpu_torch.ops.forward_sum import _masked_logp, forward_sum_loss
from aligner_tpu_torch.ops.forward_sum_kernel import NEG, forward_sum_alpha


def make_case(seed, B, T_x, T_y, *, edges=False, neg_inf=False):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, T_y, T_x)) * 2).astype(np.float32)
    t_x = rng.integers(1, T_x + 1, B).astype(np.int32)
    t_y = np.maximum(t_x, rng.integers(1, T_y + 1, B)).astype(np.int32)
    t_x[0], t_y[0] = T_x, T_y
    if edges:
        t_x[1], t_y[1] = min(T_x, T_y), min(T_x, T_y) - 1   # t_x > t_y
        t_x[2] = 0
    if neg_inf:
        # -inf-masked text positions, as a caller's masked softmax gives.
        logits = np.where(np.arange(T_x)[None, None, :] < t_x[:, None, None],
                          logits, -np.inf).astype(np.float32)
    lp = logits - np.logaddexp.reduce(
        np.where(np.isinf(logits), -1e30, logits), axis=-1, keepdims=True)
    return lp.astype(np.float32), t_x, t_y


CASES = [
    # seed, B, T_x, T_y, edges, neg_inf
    (0, 3, 5, 12, False, False),
    (1, 4, 8, 23, True, False),
    (2, 4, 6, 30, False, True),
    (3, 5, 11, 40, True, True),
    (4, 2, 16, 16, False, False),
]


@pytest.mark.parametrize("seed,B,T_x,T_y,edges,neg_inf", CASES)
def test_loss_matches_jax(seed, B, T_x, T_y, edges, neg_inf):
    lp, t_x, t_y = make_case(seed, B, T_x, T_y, edges=edges, neg_inf=neg_inf)
    got = forward_sum_loss(torch.from_numpy(lp), torch.from_numpy(t_x),
                           torch.from_numpy(t_y))
    want = np.asarray(jax_fs.forward_sum_loss(
        jnp.asarray(lp), jnp.asarray(t_x), jnp.asarray(t_y)))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    valid = (t_x >= 1) & (t_x <= t_y)
    assert (got.numpy()[~valid] == 0).all()
    assert (got.numpy()[valid] >= 0).all()    # -log of a probability


@pytest.mark.parametrize("seed", [5, 6])
def test_alpha_lattice_matches_jax_scan(seed):
    lp, t_x, t_y = make_case(seed, 4, 7, 25, edges=True)
    masked = _masked_logp(torch.from_numpy(lp), torch.from_numpy(t_x))
    lp_tm = masked.transpose(0, 1)
    alphas, final = forward_sum_alpha(lp_tm, torch.from_numpy(t_y))
    want = np.asarray(jax_fs._alpha_scan(jnp.asarray(lp_tm.numpy()),
                                         jnp.asarray(t_y)))
    np.testing.assert_allclose(alphas.numpy(), want, rtol=1e-5)
    torch.testing.assert_close(final, alphas[-1])


def test_masked_logp_clamps_neg_inf():
    lp = torch.tensor([[[0.0, -np.inf, -1.0]]])
    got = _masked_logp(lp, torch.tensor([2]))
    assert torch.equal(got, torch.tensor([[[0.0, NEG, NEG]]]))

