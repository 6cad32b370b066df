"""The cluster plan of the MoBo sweeps H7, H8 and H9 (`_cluster_plan`
and H8's `_bp_plan` in aligner_tpu_torch/ops/mobo_kernel.py), on the CPU:
the kernels take the blocks per item C and the positions per block w from
it and never infer them, so its invariants are the kernels'
preconditions. A numpy emulation of H8's sliced max/argmax, with its
D-cell halo, and of its walk over the backpointers the slices wrote is
held to the plain version under hypothesis-drawn ties.

    python -m pytest -q tests/test_torch_mobo_plan.py
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from aligner_tpu_torch.ops.mobo_kernel import (MAX_CLUSTER, MAX_SMEM,
                                               MIN_SLICE, NEG, SMS, _bp_plan,
                                               _cluster_plan, _slice_floats,
                                               _sweep_smem)


@pytest.mark.parametrize("B", [1, 4, 16, 64, 256])
@pytest.mark.parametrize("D", [1, 4, 6, 32, 64])
@pytest.mark.parametrize("n", [2, 41, 131, 301, 1025, 1101, 4097])
def test_cluster_plan_keeps_its_invariants(n, D, B):
    """C within the portable cluster size; the slices cover the n
    positions and each block owns at least one; a block with neighbours
    owns at least max(D, 32) positions, so its halo comes from one
    neighbour; B*C within the card's SMs while B is; C does not grow with
    B."""
    C, w = _cluster_plan(B, n, D)
    assert 1 <= C <= MAX_CLUSTER
    assert w >= min(D, n)
    assert C * w >= n > (C - 1) * w
    if C > 1:
        assert w >= max(D, MIN_SLICE)
    if B <= SMS:
        assert B * C <= SMS
    assert C <= _cluster_plan(max(1, B // 2), n, D)[0]


@pytest.mark.parametrize("B,plan", [(16, (8, 129)), (64, (2, 513)),
                                    (256, (1, 1025))])
def test_cluster_plan_at_the_main_path_shape(B, plan):
    """T_mel 1024 (1025 positions), D = 32: 128 of the card's 132 SMs at
    the training batch and at B = 64; one block per item at the serving
    batch."""
    assert _cluster_plan(B, 1025, 32) == plan


# ---- H8 (`_bp_plan`): its launch fits wherever its first design's did ----

FIRST_DESIGN_FLOATS = MAX_SMEM // 4   # 3 * T_y1 + 4 * D floats at most


@pytest.mark.parametrize("B", [1, 16, 64, 256])
@pytest.mark.parametrize("T_x", [1, 128, 1000])
@pytest.mark.parametrize("n,D", [(2, 1), (131, 32), (301, 4), (1025, 32),
                                 (1025, 255), (1025, 256), (1101, 32),
                                 (2001, 1000), (4097, 1), (9001, 4000),
                                 (19369, 1), (5000, 10778)])
def test_bp_plan_fits_wherever_the_first_design_did(B, T_x, n, D):
    """Every (B, T_x, T_y1, D) the one-block design took (3 T_y1 + 4 D
    floats of shared memory) has a launch within a block's shared memory:
    the clusters of `_cluster_plan` with z in shared memory only where it
    fits; the wide form where they do not fit, or where there are more
    items than SMs."""
    assert 3 * n + 4 * D <= FIRST_DESIGN_FLOATS
    C, w, z_shared, smem = _bp_plan(B, T_x, n, D)
    assert smem <= MAX_SMEM
    if C == 0:
        assert (w, z_shared) == (n, False)
        assert smem == 4 * (3 * n + 4 * D)
        assert (B > SMS or _sweep_smem(T_x, _cluster_plan(B, n, D)[1],
                                       D)[1] > MAX_SMEM)
        return
    assert B <= SMS
    assert (C, w) == _cluster_plan(B, n, D)
    assert (z_shared, smem) == _sweep_smem(T_x, w, D)
    if not z_shared:
        assert 4 * (_slice_floats(w, D) + T_x * w) > MAX_SMEM


def test_bp_plan_past_the_sms_keeps_clusters_the_wide_form_cannot_hold():
    """More items than SMs take the wide form only where its row fits: a
    grid of 30000 positions takes clusters at any batch."""
    assert 3 * 30000 + 4 > FIRST_DESIGN_FLOATS
    for B in (16, SMS + 1, 256):
        C, w, _, smem = _bp_plan(B, 128, 30000, 1)
        assert (C, w) == _cluster_plan(B, 30000, 1) and smem <= MAX_SMEM


def test_bp_plan_past_both_forms_raises():
    """A window as wide as the grid fits neither the clusters' rows nor the
    first design's."""
    with pytest.raises(ValueError, match="3 \\* T_y1 \\+ 4 \\* D"):
        _bp_plan(1, 128, 20000, 20000)


def test_bp_plan_at_the_main_path_shape():
    """Phase 7's shape (B = 16, 128 tokens, 1025 positions, D = 32): 8
    blocks of 129 positions, z in shared memory; at B = 64, z in the bp
    rows; at B = 256, more items than SMs, the wide form."""
    assert _bp_plan(16, 128, 1025, 32)[:3] == (8, 129, True)
    assert _bp_plan(64, 128, 1025, 32)[:3] == (2, 513, False)
    assert _bp_plan(256, 128, 1025, 32)[:2] == (0, 1025)


# ---- H8's sliced max/argmax and its walk across slices, emulated ----

def window_max_argmax(row, D, wb):
    """csrc/mobo.cu's window over a block's row (D halo cells, then its wb
    cells): d ascending, a later d replacing only if strictly greater."""
    m = row[D - 1:D - 1 + wb].copy()
    arg = np.ones(wb, np.int32)
    for d in range(2, D + 1):
        cand = row[D - d:D - d + wb]
        take = cand > m
        m = np.where(take, cand, m)
        arg = np.where(take, d, arg)
    return m, arg


def emulated_bp(e_tm, t_x, t_y, D, C, w):
    """H8 as csrc/mobo.cu runs it on a cluster of C blocks of w positions:
    per token, a = carry - z on every cell; each block's window reads its
    own cells and, left of them, the D-cell halo its left neighbour pushed
    (NEG for block 0); max and argmax as `window_max_argmax`, each block
    storing its slice's d. Then one thread walks from t_y over the stored
    backpointers, its position crossing the slices. Returns (bp int32 [T_x, B, n], durations int32 [B, T_x])."""
    from aligner_tpu_torch.ops.mobo_kernel import _window_normalizer
    T_x, B, n = e_tm.shape
    neg = np.float32(NEG)
    bp = np.zeros((T_x, B, n), np.int32)
    durs = np.zeros((B, T_x), np.int32)
    for b in range(B):
        tx = int(t_x[b])
        live = min(max(tx, 0), T_x)
        carry = np.full(n, neg, np.float32)
        carry[0] = 0
        for i in range(live):
            z = _window_normalizer(e_tm[i, b], D).numpy()
            a = np.where(z > neg / 2, carry - z, neg).astype(np.float32)
            e = e_tm[i, b].numpy()
            for r in range(C):
                start = r * w
                wb = min(w, n - start)
                halo = (a[start - D:start] if r > 0
                        else np.full(D, neg, np.float32))
                row = np.concatenate([halo, a[start:start + wb]])
                m, arg = window_max_argmax(row, D, wb)
                v = (e[start:start + wb] + m).astype(np.float32)
                carry[start:start + wb] = np.where(v > neg / 2, v, neg)
                bp[i, b, start:start + wb] = arg
        pos = int(t_y[b])
        for i in range(T_x - 1, -1, -1):
            pos = min(max(pos, 0), n - 1)
            d = int(bp[i, b, pos]) if i < tx else 0
            durs[b, i] = d
            pos -= d
    return bp, durs


@st.composite
def sliced_grids(draw):
    """A small grid of integer energies (ties in every window) with items
    of every kind (t_x = 0, t_x > t_y, t_x > T_x, no boundary sequence,
    feasible), a window D and a cluster of C blocks of w >= D positions."""
    B = draw(st.integers(1, 4))
    T_x = draw(st.integers(1, 6))
    T_y = draw(st.integers(1, 40))
    D = draw(st.integers(1, 8))
    n = T_y + 1
    w = draw(st.integers(min(D, n), n))
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
    energies = rng.integers(-1, 2, (B, T_y, T_x)).astype(np.float32)
    t_x = rng.integers(0, T_x + 2, B).astype(np.int32)
    t_y = rng.integers(0, T_y + 1, B).astype(np.int32)
    return energies, t_x, t_y, D, -(-n // w), w


@settings(max_examples=40, deadline=None)
@given(grid=sliced_grids())
def test_sliced_bp_and_walk_equal_the_plain_version(grid):
    """The slices with their halos and the walk across them give
    `mobo_bp_plain`'s backpointers on tokens < t_x and its durations."""
    from aligner_tpu_torch.ops.mobo import _prep_energies
    from aligner_tpu_torch.ops.mobo_kernel import mobo_bp_plain
    energies, t_x, t_y, D, C, w = grid
    tx, ty = torch.from_numpy(t_x), torch.from_numpy(t_y)
    e_tm = _prep_energies(torch.from_numpy(energies), tx, ty)
    got_bp, got_durs = emulated_bp(e_tm, t_x, t_y, D, C, w)
    want_bp, want_durs = mobo_bp_plain(e_tm, tx, ty, D)
    live = np.arange(e_tm.shape[0])[:, None, None] < t_x[None, :, None]
    np.testing.assert_array_equal(got_bp * live, want_bp.numpy() * live)
    np.testing.assert_array_equal(got_durs, want_durs.numpy())
