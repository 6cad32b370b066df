"""aligner_tpu_torch BatchAligner and SkipBatchAligner against
aligner_tpu's (interpret mode, tiny bucket): identical paths and
durations, including a partial last slice, and the same refusal of
oversize lattices."""
import numpy as np
import pytest

import aligner_tpu
from aligner_tpu.serving import SkipBatchAligner as JaxSkipBatchAligner
from aligner_tpu_torch import BatchAligner, SkipBatchAligner
from aligner_tpu_torch.ops.skip_dp_reference import mas_skip_single


def make_lattices(n, max_tx=10, max_ty=24, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tx = int(rng.integers(1, max_tx + 1))
        ty = int(rng.integers(tx, max_ty + 1))
        out.append((rng.standard_normal((tx, ty)) * 3).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def aligners():
    """(port, JAX) aligners on one 10x24 bucket, 3 lattices per slice."""
    return (BatchAligner(max_text=10, max_mel=24, max_batch=3, device="cpu"),
            aligner_tpu.BatchAligner(max_text=10, max_mel=24, max_batch=3,
                                     interpret=True))


@pytest.mark.parametrize("n,seed", [(7, 0), (3, 1)])   # partial, full slice
def test_align_matches_jax(aligners, n, seed):
    port, ref = aligners
    lats = make_lattices(n, seed=seed)
    got, want = port.align(lats), ref.align(lats)
    assert len(got) == len(want) == n
    for lat, (path, durs), (w_path, w_durs) in zip(lats, got, want):
        assert path.shape == lat.shape and path.dtype == np.int8
        np.testing.assert_array_equal(path, w_path)
        np.testing.assert_array_equal(durs, w_durs)
        assert durs.dtype == np.int32 and durs.sum() == lat.shape[1]


@pytest.mark.parametrize("n,seed", [(7, 2), (2, 3)])
def test_align_durations_matches_jax(aligners, n, seed):
    port, ref = aligners
    lats = make_lattices(n, seed=seed)
    got, want = port.align_durations(lats), ref.align_durations(lats)
    assert len(got) == n
    for d, w, (_, d_full) in zip(got, want, port.align(lats)):
        np.testing.assert_array_equal(d, w)
        np.testing.assert_array_equal(d, d_full)


def test_rejects_oversize():
    aligner = BatchAligner(max_text=4, max_mel=8, device="cpu")
    with pytest.raises(ValueError, match="exceeds the bucket"):
        aligner.align([np.zeros((5, 8), np.float32)])
    with pytest.raises(ValueError, match="exceeds the bucket"):
        aligner.align_durations([np.zeros((4, 9), np.float32)])


def make_state_lattices(n, max_tx=5, max_ty=20, seed=0):
    """Ragged state-major lattices [2*t_x+1, t_y]."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tx = int(rng.integers(1, max_tx + 1))
        ty = int(rng.integers(tx, max_ty + 1))
        out.append(rng.standard_normal((2 * tx + 1, ty)).astype(np.float32))
    return out


@pytest.mark.parametrize("n,seed,cost", [(7, 0, 0.0), (3, 1, 0.0),
                                         (5, 2, -0.8)])
def test_skip_align_matches_jax_and_the_oracle(n, seed, cost):
    """Partial and full slices on one 5x20 bucket, 3 lattices per slice,
    with and without an enter cost."""
    port = SkipBatchAligner(max_text=5, max_mel=20, max_batch=3,
                            enter_cost=cost, device="cpu")
    ref = JaxSkipBatchAligner(max_text=5, max_mel=20, max_batch=3,
                              interpret=True, enter_cost=cost)
    lats = make_state_lattices(n, seed=seed)
    got, want = port.align(lats), ref.align(lats)
    assert len(got) == len(want) == n
    for lat, (path, tok, pause), (w_path, w_tok, w_pause) in zip(
            lats, got, want):
        ts, ty = lat.shape
        assert path.shape == lat.shape and path.dtype == np.float32
        np.testing.assert_array_equal(path, w_path)
        np.testing.assert_array_equal(path, mas_skip_single(
            lat.copy(), (ts - 1) // 2, ty, enter_cost=cost))
        np.testing.assert_array_equal(tok, w_tok)
        np.testing.assert_array_equal(pause, w_pause)
        assert tok.dtype == pause.dtype == np.int32
        assert tok.shape == ((ts - 1) // 2,) and len(pause) == len(tok) + 1
        assert tok.sum() + pause.sum() == ty


def test_skip_align_takes_token_counts_and_rejects_bad_lattices():
    aligner = SkipBatchAligner(max_text=4, max_mel=8, max_batch=2,
                               device="cpu")
    lats = make_state_lattices(3, max_tx=4, max_ty=8, seed=4)
    counts = [(lat.shape[0] - 1) // 2 for lat in lats]
    for a, b in zip(aligner.align(lats), aligner.align(lats, counts)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="state rows"):
        aligner.align([np.zeros((6, 8), np.float32)])
    with pytest.raises(ValueError, match="state rows"):
        aligner.align(lats, [c + 1 for c in counts])
    with pytest.raises(ValueError, match="exceeds the bucket"):
        aligner.align([np.zeros((11, 8), np.float32)])
    with pytest.raises(ValueError, match="exceeds the bucket"):
        aligner.align([np.zeros((9, 9), np.float32)])
