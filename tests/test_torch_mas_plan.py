"""The launch plans of the MAS kernels H1 (`ops/mas_kernel.py:_mas_plan`)
and H13 (`_chains_plan`, K of H1's forward chains a block) and H1's walk,
checked on the CPU: the place of the bit plane, the fetch,
a shared-memory layout the card would refuse, a plan the kernel was not
built for, or a word walk that leaves the plain walk's path shows here
before any launch.

    python -m pytest -q tests/test_torch_mas_plan.py
"""
import os
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from aligner_tpu_torch.ops.forward_sum_kernel import MAX_THREADS
from aligner_tpu_torch.ops.mas_kernel import (MAS_PLANS, MAX_SMEM,
                                              _chains_plan, _forward_smem,
                                              _mas_plan, _mas_smem, mas_bits,
                                              mas_expand_plain,
                                              mas_walk_idx_plain)

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "aligner_tpu_torch", "csrc")
MAS_SOURCE = os.path.join(CSRC, "mas_forward.cuh")   # with_mas_plan

WIDEST = MAS_PLANS[-1][0] * MAX_THREADS       # 8192 tokens
# (T_x, T_y): the lattices of the paths and the card tests (128x1024,
# config 5's 128x2048, the long form 128x8192, the odd 45x300, T_x = 1100
# with two cells a thread), a single frame, the edges of each cell count,
# lattices whose plane fits only behind the shallow ring or not at all,
# and columns past the widest plan.
SHAPES = ((1, 1), (16, 61), (45, 300), (128, 1024), (128, 2048),
          (128, 8192), (128, 20000), (1024, 256), (1025, 256), (1100, 1300),
          (2048, 100), (2049, 100), (4096, 30), (4097, 30), (8192, 10),
          (8192, 1024))


@pytest.mark.parametrize("frames_contiguous", [True, False])
@pytest.mark.parametrize("T_x,T_y", SHAPES)
def test_plan_covers_the_column_within_the_card(T_x, T_y, frames_contiguous):
    threads, cells, ring, planes, fetch, smem = _mas_plan(
        T_x, T_y, frames_contiguous)
    assert (cells, ring, planes, fetch) in MAS_PLANS
    assert threads * cells >= T_x                 # every token has a thread
    assert threads % 32 == 0 and 32 <= threads <= MAX_THREADS
    assert (threads - 32) * cells < T_x           # no warp without a token
    assert ring >= (24 if fetch == "tiles" else 2)   # fetched ahead
    assert ring & (ring - 1) == 0                 # slots by a mask
    assert fetch == "rows" or frames_contiguous
    pitch = threads * cells
    frames = T_y if planes == "shared" else 0
    assert smem == (4 * (pitch // 32) + 2) * frames \
        + 4 * (ring * (pitch + 4) + 2 * (pitch + 1)) <= MAX_SMEM
    # the fewest cells that cover the column, and the first plan of that
    # count and a fetch the lattice takes that fits
    assert cells == min(c for c, *_ in MAS_PLANS if c * MAX_THREADS >= T_x)
    for c, r, p, f in MAS_PLANS[:MAS_PLANS.index(
            (cells, ring, planes, fetch))]:
        if c == cells and (f == "rows" or frames_contiguous):
            assert _mas_smem(pitch, r, T_y if p == "shared" else 0) \
                > MAX_SMEM


@pytest.mark.parametrize("T_x,T_y,frames_contiguous,want", [
    # phase 7's batch in serving's natural layout and the training step's
    # frame-major one: 16 KB of plane
    (128, 1024, True, (128, 1, 32, "shared", "tiles")),
    (128, 1024, False, (128, 1, 8, "shared", "rows")),
    # config 5 and the long form: 32 KB and 128 KB of plane
    (128, 2048, True, (128, 1, 32, "shared", "tiles")),
    (128, 2048, False, (128, 1, 8, "shared", "rows")),
    (128, 8192, True, (128, 1, 32, "shared", "tiles")),
    (128, 8192, False, (128, 1, 8, "shared", "rows")),
    # the odd shape: T_x no multiple of 32
    (45, 300, True, (64, 1, 32, "shared", "tiles")),
    # two cells a thread: the plane behind the shallow ring
    (1100, 1300, True, (576, 2, 4, "shared", "rows")),
    # a plane too long for shared memory
    (128, 60000, True, (128, 1, 32, "global", "tiles")),
    (1100, 3000, False, (576, 2, 8, "global", "rows"))])
def test_plans_of_the_paths(T_x, T_y, frames_contiguous, want):
    assert _mas_plan(T_x, T_y, frames_contiguous)[:5] == want


@pytest.mark.parametrize("T_x", [WIDEST + 1, 20000, MAX_SMEM // 8])
def test_columns_past_the_widest_plan_take_the_wide_kernel(T_x):
    """H1 took any column whose two float columns fit in a block's shared
    memory before its plans existed; past the widest plan it still does,
    with threads striding the column and the plane in device memory."""
    for frames_contiguous in (True, False):
        threads, cells, ring, planes, fetch, smem = _mas_plan(
            T_x, 50, frames_contiguous)
        assert (ring, planes, fetch) == (0, "global", "wide")
        assert cells == -(-T_x // MAX_THREADS)
        assert threads % 32 == 0 and threads <= MAX_THREADS
        assert threads * cells >= T_x > (threads - 32) * cells
        assert smem == 8 * T_x <= MAX_SMEM


def test_columns_past_shared_memory_raise():
    with pytest.raises(ValueError, match="at most 29056 tokens"):
        _mas_plan(MAX_SMEM // 8 + 1, 10, True)


def test_every_plan_group_has_a_plan_that_always_fits():
    """The device-memory plan of each cell count and fetch fits at its
    widest column, so a plan exists for every T_y."""
    for cells, fetch in {(c, f) for c, _, _, f in MAS_PLANS}:
        rings = [r for c, r, p, f in MAS_PLANS
                 if (c, p, f) == (cells, "global", fetch)]
        assert len(rings) == 1
        assert _mas_smem(cells * MAX_THREADS, rings[0], 0) <= MAX_SMEM
        plan = _mas_plan(cells * MAX_THREADS, 200000, fetch == "tiles")
        assert plan[3:5] == ("global", fetch)


def test_plans_match_the_kernels_built():
    """Every plan of MAS_PLANS is one that `with_mas_plan` dispatches, and
    no other: a plan the kernel was not built for would be refused."""
    with open(MAS_SOURCE) as f:
        source = f.read()
    lines = re.findall(
        r"cells == (\d+) && ring == (\d+) && (!?)shared && (!?)tiles\)"
        r"\s*return f\(MasPlan<(\d+), (\d+), (true|false), (true|false)>",
        source)
    built = set()
    for cells, ring, not_shared, not_tiles, c2, r2, shared, tiles in lines:
        assert (cells, ring) == (c2, r2)
        assert (not_shared == "") == (shared == "true")
        assert (not_tiles == "") == (tiles == "true")
        built.add((int(cells), int(ring),
                   "shared" if shared == "true" else "global",
                   "tiles" if tiles == "true" else "rows"))
    assert len(lines) == len(built) == len(MAS_PLANS)
    assert built == set(MAS_PLANS)


def test_both_kernels_dispatch_through_the_plans():
    """H1 and H13 launch through `with_mas_plan`, each instantiating its
    kernel with the plan's cells, ring, planes and fetch, so MAS_PLANS is
    the table of both."""
    for name, kernel in (("mas.cu", "mas_kernel"),
                         ("mas_two_pass.cu", "mas_bits_chains_kernel")):
        with open(os.path.join(CSRC, name)) as f:
            source = f.read()
        assert '#include "mas_forward.cuh"' in source
        assert "with_mas_plan(" in source
        assert (f"{kernel}<P::cells, P::ring, P::shared, P::tiles>"
                in source)


CHAIN_LIMITS = {K: MAX_SMEM // (8 * K) for K in (2, 4)}   # 14528, 7264


@pytest.mark.parametrize("K", [2, 4])
@pytest.mark.parametrize("frames_contiguous", [True, False])
@pytest.mark.parametrize("T_x,T_y", SHAPES[:12] + (
    (2048, 1024), (2049, 100), (4096, 30), (4097, 30), (7264, 7280),
    (14528, 5)))
def test_chains_plan_covers_the_column_within_the_card(T_x, T_y, K,
                                                      frames_contiguous):
    """Every column H13 took before its plans (K chains' two float columns
    in a block's shared memory) has a plan: whole warps a chain, K chains
    within 1024 threads and 227 KB, a plan of MAS_PLANS (the first that
    fits, tiles only where the frames are contiguous) or the wide form."""
    if T_x > CHAIN_LIMITS[K]:
        with pytest.raises(ValueError, match=f"{K} chains takes at most"):
            _chains_plan(T_x, T_y, K, frames_contiguous)
        return
    threads, cells, ring, planes, fetch, smem = _chains_plan(
        T_x, T_y, K, frames_contiguous)
    assert threads % 32 == 0 and K * threads <= MAX_THREADS
    assert threads * cells >= T_x > (threads - 32) * cells
    assert smem <= MAX_SMEM
    if fetch == "wide":
        assert (ring, planes, smem) == (0, "global", 8 * K * T_x)
        assert cells == -(-T_x // (MAX_THREADS // K))
        # a device-memory plan fits wherever a plan covers the column
        assert T_x > MAS_PLANS[-1][0] * (MAX_THREADS // K)
        return
    assert (cells, ring, planes, fetch) in MAS_PLANS
    assert fetch == "rows" or frames_contiguous
    assert smem == K * _forward_smem(threads * cells, ring,
                                     T_y if planes == "shared" else 0)
    assert cells == min(c for c, *_ in MAS_PLANS
                        if c * (MAX_THREADS // K) >= T_x)
    for c, r, p, f in MAS_PLANS[:MAS_PLANS.index(
            (cells, ring, planes, fetch))]:
        if c == cells and (f == "rows" or frames_contiguous):
            assert K * _forward_smem(threads * cells, r,
                                     T_y if p == "shared" else 0) > MAX_SMEM


@pytest.mark.parametrize("T_x,T_y,K,frames_contiguous,want", [
    # phase 7's batch: four 16 KB planes beside their rings
    (128, 1024, 2, True, (128, 1, 32, "shared", "tiles")),
    (128, 1024, 4, True, (128, 1, 32, "shared", "tiles")),
    (128, 1024, 4, False, (128, 1, 8, "shared", "rows")),
    (45, 300, 4, True, (64, 1, 32, "shared", "tiles")),
    # T_x = 1100: eight cells a thread at K = 4, the planes in device memory
    (1100, 1300, 4, True, (160, 8, 4, "global", "rows")),
    (1100, 1300, 2, True, (288, 4, 8, "global", "rows"))])
def test_chains_plans_of_the_paths(T_x, T_y, K, frames_contiguous, want):
    assert _chains_plan(T_x, T_y, K, frames_contiguous)[:5] == want


# ---- the plane and the word walk, emulated as csrc/mas.cu runs them ----

def pack_plane(bits, t_x, t_y, words):
    """The plane of csrc/mas.cu (`load_planes`): uint32 [B, T_y, words],
    bit x % 32 of word x // 32 = (byte != 0) for 0 < x < t_x on frames
    y < t_y, as one ballot a warp per word; every other bit clear."""
    B, T_y, T_x = bits.shape
    xs = np.arange(32 * words)
    set_ = np.zeros((B, T_y, 32 * words), bool)
    set_[:, :, :T_x] = bits != 0
    set_ &= (xs > 0) & (xs < t_x[:, None, None])
    set_ &= np.arange(T_y)[None, :, None] < t_y[:, None, None]
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    return (set_.reshape(B, T_y, words, 32).astype(np.uint64)
            * weights).sum(-1).astype(np.uint32)


def word_walk(plane, tx, ty):
    """The walk of csrc/mas.cu (`walk`) over one item's plane: four frames
    a round from the two words read before them, then one a frame; returns
    each frame's token (-1 for no emission)."""
    token = np.full(plane.shape[0], -1)
    index, y = tx - 1, ty - 1
    while y >= 4:
        w = index >> 5
        hi = [int(plane[y - j, w]) for j in range(4)]
        lo = [int(plane[y - j, max(w - 1, 0)]) for j in range(4)]
        for j in range(4):
            assert (index >> 5) in (w, w - 1)     # the words read ahead
            word = hi[j] if (index >> 5) == w else lo[j]
            token[y - j] = index
            index -= (word >> (index & 31)) & 1
        y -= 4
    while y > 0:
        token[y] = index
        index -= (int(plane[y, index >> 5]) >> (index & 31)) & 1
        y -= 1
    token[0] = index
    return token


def emulated_tokens(bits, t_x, t_y, words):
    """Each frame's token + 1 (0: no emission), int32 [B, T_y], as
    `mas_walk_idx_plain` returns it: the plane of the given bytes, the
    word walk for the valid items, -1 elsewhere."""
    B, T_y, T_x = bits.shape
    plane = pack_plane(bits, t_x, t_y, words)
    out = np.full((B, T_y), -1)
    for b in range(B):
        if 1 <= t_x[b] <= t_y[b] and t_x[b] <= T_x and t_y[b] <= T_y:
            out[b] = word_walk(plane[b], int(t_x[b]), int(t_y[b]))
    return (out + 1).astype(np.int32)


@st.composite
def tie_batches(draw):
    """A ragged batch of small integers (equal DP sums are common) with
    the contract's edges: t_x = 1, t_x = t_y, t_x = 0, t_x > t_y and
    t_x = T_x + 1; tokens past one word a frame."""
    B = draw(st.sampled_from([4, 8]))
    T_x = draw(st.integers(1, 70))
    T_y = draw(st.integers(T_x, 110))
    seed = draw(st.integers(0, 2**32 - 1))
    rng = np.random.default_rng(seed)
    value = rng.integers(-2, 3, (B, T_x, T_y)).astype(np.float32)
    t_x = rng.integers(0, T_x + 2, B).astype(np.int32)
    t_y = rng.integers(1, T_y + 1, B).astype(np.int32)
    t_x[0], t_y[0] = T_x, T_y
    t_x[1], t_y[1] = 1, rng.integers(1, T_y + 1)
    t_x[2] = t_y[2] = min(T_x, T_y)
    return value, t_x, t_y


@pytest.mark.parametrize("cells", [1, 2])
@settings(max_examples=25, deadline=None)
@given(batch=tie_batches())
def test_word_walk_equals_the_plain_walk(cells, batch):
    """The plane packing and the four-frames-a-round word walk, from
    `mas_bits`' plain bits, and from bits from elsewhere (bytes of 3, ones
    at token 0), give `mas_walk_idx_plain`'s tokens, and the path written
    whole from them is `mas_expand_plain`'s."""
    value, t_x, t_y = batch
    v, tx, ty = (torch.from_numpy(a) for a in batch)
    bits = mas_bits(v, tx, ty)
    words = cells * -(-value.shape[1] // 32)     # the plan's pitch / 32
    foreign = bits * 3
    foreign[:, :, 0] = 1
    for given_bits in (bits, foreign):
        got = emulated_tokens(given_bits.numpy(), t_x, t_y, words)
        want = mas_walk_idx_plain(given_bits, tx, ty)
        np.testing.assert_array_equal(got, want.numpy())
        np.testing.assert_array_equal(
            mas_expand_plain(torch.from_numpy(got), value.shape[1]).numpy(),
            mas_expand_plain(want, value.shape[1]).numpy())


# ---- the byte writer, emulated as csrc/mas_forward.cuh runs it ----

def write_bytes16(plane, tx, ty, valid, T_x, T_y):
    """`write_bits` where T_x % 16 == 0: one store of 16 bytes a step,
    the band of cells x..x+15 a mask of the plane word's 16 bits, each
    nibble spread to 4 bytes by one multiply (`bytes4`)."""
    out = np.zeros((T_y, T_x), np.uint8)
    top = ty if valid else 0
    for y in range(T_y):
        for x in range(0, T_x, 16):
            lo = max(tx - (ty - y) - x, 0)
            hi = min(min(tx - 1, y) - x, 15)
            m = 0
            if y < top and lo <= hi:
                m = (int(plane[y, x >> 5]) >> (x & 31)) & ((2 << hi)
                                                           - (1 << lo))
            for q in range(4):
                four = (((m >> 4 * q) & 15) * 0x00204081) & 0x01010101
                out[y, x + 4 * q:x + 4 * q + 4] = np.frombuffer(
                    four.to_bytes(4, "little"), np.uint8)
    return out


@st.composite
def sixteen_wide_batches(draw):
    """A ragged batch of small integers over a column of a multiple of 16
    tokens, with the contract's edges, and a plane whose bits off each
    item's band are random (the forward leaves them so)."""
    B = 4
    T_x = 16 * draw(st.integers(1, 4))
    T_y = draw(st.integers(T_x, 100))
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
    value = rng.integers(-2, 3, (B, T_x, T_y)).astype(np.float32)
    t_x = rng.integers(0, T_x + 2, B).astype(np.int32)
    t_y = rng.integers(1, T_y + 1, B).astype(np.int32)
    t_x[0], t_y[0] = T_x, T_y
    t_x[1] = t_y[1] = min(T_x, T_y)
    noise = rng.integers(0, 2**32, (B, T_y, T_x // 32 + 1), dtype=np.uint64)
    return value, t_x, t_y, noise.astype(np.uint32)


@settings(max_examples=25, deadline=None)
@given(batch=sixteen_wide_batches())
def test_sixteen_byte_writer_equals_the_plain_bits(batch):
    """The 16-bytes-a-store writer over a plane that holds the forward's
    bits on the band and noise off it gives `mas_bits`' plain bytes on
    every cell: 0 off the band, past t_x and t_y and on invalid items."""
    value, t_x, t_y, noise = batch
    B, T_x, T_y = value.shape
    want = mas_bits(*(torch.from_numpy(a) for a in (value, t_x, t_y)))
    words = noise.shape[-1]
    xs, ys = np.arange(32 * words), np.arange(T_y)[:, None]
    for b in range(B):
        tx, ty = int(t_x[b]), int(t_y[b])
        valid = 1 <= tx <= ty and tx <= T_x and ty <= T_y
        band = (xs < tx) & (xs <= ys) & (xs >= tx - (ty - ys))
        own = pack_plane(want[b:b + 1].numpy(), t_x[b:b + 1],
                         t_y[b:b + 1], words)[0]
        keep = (band.reshape(T_y, words, 32).astype(np.uint64)
                << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
        plane = (own & keep) | (noise[b] & ~keep)
        got = write_bytes16(plane, tx, ty, valid, T_x, T_y)
        np.testing.assert_array_equal(got, want[b].numpy())
