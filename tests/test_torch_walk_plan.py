"""The ring walk of H10 (`mas_walk_stage_kernel`), H14
(`mas_walk_chains_kernel`) and H11 (`mas_walk_idx_kernel`),
`csrc/mas_walk.cuh`, checked on the CPU: its launch plan
(`ops/mas_kernel.py:_walk_plan`: frames a chunk, stages, fetch; H11's
group of IDX_WALK_THREADS), the plans the header builds, and a numpy
emulation of the chunked ring (bytes fetched ahead into S stages, the
four-frames-a-round walk from two words a frame picked by one byte
permute, tokens handed to the storers S stages deep, which write the
path's tiles or H11's int32 index row) held to the plain walk under
hypothesis-drawn ties, before any launch.

    python -m pytest -q tests/test_torch_walk_plan.py
"""
import os
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from test_torch_mas_plan import tie_batches

from aligner_tpu_torch.ops.mas_kernel import (IDX_WALK_THREADS, MAX_SMEM,
                                              WALK_FETCHES, WALK_MAX_T_X,
                                              WALK_PLANS, WALK_THREADS,
                                              _walk_plan, _walk_smem,
                                              mas_backtrack, mas_bits,
                                              mas_expand_plain,
                                              mas_walk_idx_plain)

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "aligner_tpu_torch", "csrc")
H1_WIDEST = MAX_SMEM // 8      # 29056 tokens: H1's widest column

# (T_x, T_y): the odd shape, the paths' 128x1024 and the long form, two
# cells a thread of H1, columns past 8192 tokens and H1's widest.
COLUMNS = ((1, 1), (45, 300), (128, 1024), (128, 8192), (1100, 1300),
           (2100, 2200), (7264, 7280), (8200, 300), (14528, 20),
           (20000, 9), (H1_WIDEST, 3))


@pytest.mark.parametrize("K", [1, 2, 4])
@pytest.mark.parametrize("T_x,T_y", COLUMNS)
def test_walk_plan_covers_the_column_within_the_card(T_x, T_y, K):
    """Every column up to H1's widest has a plan for K = 1, 2, 4: whole
    warps a chain, at least a walker, a producer and a storer warp, K
    chains within 1024 threads and K rings within 227 KB, the first plan
    of WALK_PLANS that fits."""
    threads, frames, stages, fetch, smem = _walk_plan(T_x, T_y, K, 0)
    assert threads == WALK_THREADS
    assert threads % 32 == 0 and threads >= 96 and K * threads <= 1024
    assert (frames, stages) in WALK_PLANS and fetch in WALK_FETCHES
    assert smem == K * _walk_smem(T_x, frames, stages) <= MAX_SMEM
    for f, s in WALK_PLANS[:WALK_PLANS.index((frames, stages))]:
        assert K * _walk_smem(T_x, f, s) > MAX_SMEM


@pytest.mark.parametrize("T_x,T_y,K,want", [
    # the paths' lattice: 128 frames a chunk, four 16 KB stages a chain;
    # 64 frames at K = 4
    (128, 1024, 1, (128, 4, "bulk", 66688)),
    (128, 1024, 2, (128, 4, "bulk", 133376)),
    (128, 1024, 4, (64, 4, "bulk", 133632)),
    # the odd shape: T_x % 4 != 0
    (45, 300, 4, (128, 4, "bytes", 96768)),
    # T_y * T_x no multiple of 16, T_x % 4 == 0
    (36, 301, 2, (128, 4, "async", 39168)),
    # a column past 8192 tokens: 8200 bytes a frame, no multiple of 16
    (8200, 100, 2, (2, 4, "bulk", 131488)),
    (8200, 100, 4, (1, 4, "async", 131904)),
    (1100, 1300, 4, (8, 4, "bulk", 141568)),
    # H1's widest: one frame a chunk, one stage at K = 4
    (H1_WIDEST, 3, 2, (1, 2, "bulk", 116384)),
    (H1_WIDEST, 3, 4, (1, 1, "bulk", 116416))])
def test_walk_plans_of_the_paths(T_x, T_y, K, want):
    assert _walk_plan(T_x, T_y, K, 0)[1:] == want


def test_columns_past_int16_tokens_raise():
    for K in (1, 2, 4):
        with pytest.raises(ValueError, match="at most 32767 tokens"):
            _walk_plan(WALK_MAX_T_X + 1, 2, K, 0)


@pytest.mark.parametrize("T_x,T_y", COLUMNS)
@pytest.mark.parametrize("base", [0, 4, 1])
def test_idx_walk_plan_is_the_staged_walks_with_three_warps(T_x, T_y, base):
    """H11 runs H10's frames, stages and fetch for the same column and
    base with a group of three warps: a walker, a producer and one storer,
    whose 4 B a frame need no more."""
    plan = _walk_plan(T_x, T_y, 1, base, threads=IDX_WALK_THREADS)
    assert plan[0] == IDX_WALK_THREADS == 96
    assert plan[1:] == _walk_plan(T_x, T_y, 1, base)[1:]


def test_idx_walk_columns_past_int16_tokens_raise():
    """H11 keeps the walk's tokens as int16, as H10 does: a column past
    WALK_MAX_T_X raises before any launch."""
    assert _walk_plan(WALK_MAX_T_X, 2, 1, 0, threads=IDX_WALK_THREADS)
    with pytest.raises(ValueError, match="at most 32767 tokens"):
        _walk_plan(WALK_MAX_T_X + 1, 2, 1, 0, threads=IDX_WALK_THREADS)


def test_walk_plans_match_the_kernels_built():
    """WALK_PLANS is `kWalkPlans` of csrc/mas_walk.cuh, in order, and the
    fetch codes are its WalkFetch enum; both kernels run the ring walk and
    the launch checks the plan."""
    with open(os.path.join(CSRC, "mas_walk.cuh")) as f:
        header = f.read()
    table = re.search(r"kWalkPlans\[\] = \{(.*?)\};", header, re.S).group(1)
    built = tuple((int(a), int(b))
                  for a, b in re.findall(r"\{(\d+), (\d+)\}", table))
    assert built == WALK_PLANS
    enum = re.search(r"enum WalkFetch \{(.*?)\}", header).group(1)
    assert [e.split("=")[0].strip() for e in enum.split(",")] == [
        f"WALK_{f.upper()}" for f in WALK_FETCHES]
    assert [int(e.split("=")[1]) for e in enum.split(",")] == [0, 1, 2]
    with open(os.path.join(CSRC, "mas_two_pass.cu")) as f:
        source = f.read()
    assert '#include "mas_walk.cuh"' in source
    assert source.count("ring_walk(bits + ") == 3
    assert source.count("TileStore{") == 2 and source.count("IdxStore{") == 1
    assert "kIdxWarps" not in source
    assert source.count("ring_walk_launch(\n") == 3
    assert "walk_plan_built(frames, stages)" in source


def chunks(T_y, ty, F):
    """(y0, frames) of each chunk the ring walks, top chunk first."""
    n = -(-ty // F)
    return [((n - 1 - k) * F, min(F, T_y - (n - 1 - k) * F))
            for k in range(n)]


@pytest.mark.parametrize("T_x,T_y,base", [
    (128, 1024, 0), (128, 1024, 4), (128, 1024, 1), (45, 300, 0),
    (45, 320, 0), (20, 300, 0), (20, 301, 0), (36, 301, 0), (36, 301, 2),
    (1100, 1300, 0), (H1_WIDEST, 3, 0), (6, 8, 0), (2, 8, 16)])
def test_fetch_is_bulk_exactly_where_the_alignment_allows(T_x, T_y, base):
    """"bulk" exactly where every chunk of every item starts at a 16-byte
    aligned address and is a 16-byte multiple (to the lattice's end, as
    the bulk copy loads it); "async" where each is a run of aligned
    4-byte words; else "bytes"."""
    _, F, _, fetch, _ = _walk_plan(T_x, T_y, 1, base)
    addresses = [base + b * T_y * T_x + y0 * T_x
                 for b in range(17) for y0, _ in chunks(T_y, T_y, F)]
    sizes = [nf * T_x for _, nf in chunks(T_y, T_y, F)]
    bulk = all(a % 16 == 0 for a in addresses) and all(
        s % 16 == 0 for s in sizes)
    words = all(a % 4 == 0 for a in addresses) and T_x % 4 == 0
    assert fetch == ("bulk" if bulk else "async" if words else "bytes")


# ---- the ring walk, emulated as csrc/mas_walk.cuh runs it ----

class TileStore:
    """H10's and H14's storers: each chunk's [T_x, nf] tile of the path,
    every cell, into an array of NaN."""

    def __init__(self, T_x, T_y):
        self.out = np.full((T_x, T_y), np.nan)

    def __call__(self, y0, nf, tok):
        for r in range(nf):
            self.out[:, y0 + r] = np.arange(self.out.shape[0]) == tok(r)


GARBAGE = 0x7F7F7F7F


class IdxStore:
    """H11's storer (csrc/mas_walk.cuh: walk_store_idx), store by store,
    into an int32 row of garbage at byte address `address`: token + 1 a
    frame (0 for none), one frame a store up to the first 16-byte aligned
    frame, four a store from there (each at a 16-byte aligned address),
    one a store for the frames left over; each frame written once."""

    def __init__(self, T_y, address):
        assert address % 4 == 0
        self.out = np.full(T_y, GARBAGE, np.int64)
        self.address = address
        self.quads = 0

    def __call__(self, y0, nf, tok):
        at = self.address + 4 * y0
        head = min(nf, (16 - at % 16) % 16 // 4)
        quads = (nf - head) // 4
        stores = ([(r, 1) for r in range(head)]
                  + [(head + 4 * c, 4) for c in range(quads)]
                  + [(r, 1) for r in range(head + 4 * quads, nf)])
        written = np.zeros(nf, int)
        for r, width in stores:
            assert width == 1 or (at + 4 * r) % 16 == 0
            for j in range(width):
                self.out[y0 + r + j] = tok(r + j) + 1
                written[r + j] += 1
        assert (written == 1).all()
        self.quads += quads


def ring_walk(item, tx, ty, valid, F, S, fetch, store):
    """One item's walk through the ring: the producer as far ahead as
    the empty stages let it (chunk k + S - 1 while chunk k is walked), the
    storers as far behind as the token stages let them (chunk k - S stored
    just before chunk k's tokens are written), stages that keep what an
    earlier chunk left; each chunk's frames go to store(y0, nf, tok)."""
    T_y, T_x = item.shape
    flat = item.reshape(-1)
    stage_bytes = -(-F * T_x // 16) * 16
    stages = np.full((S, stage_bytes), 0xEE, np.uint8)   # garbage
    loaded = [None] * S               # (chunk, bytes) in each stage
    ring = np.full((S, F), 12345)
    n = -(-ty // F) if valid else 0

    def store_chunk(k):
        y0 = (n - 1 - k) * F
        live = min(F, ty - y0)
        s = k % S
        store(y0, min(F, T_y - y0),
              lambda r: ring[s, r] if r < live else -1)

    def load(k):
        y0 = (n - 1 - k) * F
        frames = min(F, (T_y if fetch == "bulk" else ty) - y0)
        nb = frames * T_x
        if fetch == "bulk":
            assert (y0 * T_x) % 16 == 0 and nb % 16 == 0
        stages[k % S, :nb] = flat[y0 * T_x:y0 * T_x + nb]
        loaded[k % S] = (k, nb)

    for c in range(n, -(-T_y // F)):          # at or past t_y: zeros
        store(c * F, min(F, T_y - c * F), lambda r: -1)
    index, fetched, stored = tx - 1, -1, -1
    for k in range(n):
        while fetched < min(k + S - 1, n - 1):
            fetched += 1
            load(fetched)
        while stored < k - S:
            stored += 1
            store_chunk(stored)
        s = k % S
        chunk, nb = loaded[s]
        assert chunk == k                     # waited for its own bytes
        words = stages[s].view("<u4")
        y0 = (n - 1 - k) * F

        r = min(F, ty - y0) - 1
        while r >= 3:                         # never across a chunk
            row = [(r - j) * T_x for j in range(4)]
            w = [(row[j] + index) >> 2 for j in range(4)]
            pair = [int(words[max(w[j] - 1, 0)]) | int(words[w[j]]) << 32
                    for j in range(4)]        # (lo, hi), read ahead
            c = [row[j] - 4 * (w[j] - 1) for j in range(4)]
            for j in range(4):
                assert row[j] + index < nb    # a byte this chunk loaded
                d = c[j] + index              # the byte permute's selector
                assert 1 <= d <= 7
                ring[s, r - j] = index
                index -= (pair[j] >> (8 * d)) & 0xFF != 0 and index > 0
            r -= 4
        while r >= 0:
            o = r * T_x + index
            assert o < nb
            ring[s, r] = index
            byte = (int(words[o >> 2]) >> (8 * (o & 3))) & 0xFF
            index -= byte != 0 and index > 0
            r -= 1
    while stored < n - 1:
        stored += 1
        store_chunk(stored)


def emulate(bits, t_x, t_y, F, S, fetch, idx_base=0):
    """(the paths [B, T_x, T_y] that H10's storers write, the index rows
    [B, T_y] that H11's write into an int32 output at byte address
    idx_base, H11's four-frame stores) of the emulated ring walk."""
    B, T_y, T_x = bits.shape
    paths, rows, quads = [], [], 0
    for b in range(B):
        valid = (1 <= t_x[b] <= t_y[b] and t_x[b] <= T_x
                 and t_y[b] <= T_y)
        tile, row = TileStore(T_x, T_y), IdxStore(T_y, idx_base + 4 * b * T_y)
        for store in (tile, row):
            ring_walk(bits[b], int(t_x[b]), int(t_y[b]), valid, F, S,
                      fetch, store)
        assert not np.isnan(tile.out).any()   # every cell written
        assert (row.out != GARBAGE).all()     # every frame written
        paths.append(tile.out.astype(np.float32))
        rows.append(row.out.astype(np.int32))
        quads += row.quads
    return np.stack(paths), np.stack(rows), quads


def check_ring_walk(bits, t_x, t_y, F, S, fetch):
    """The emulated ring walk, from the given bits and from bits from
    elsewhere (bytes of 3, ones at token 0), gives `mas_walk_idx_plain`'s
    tokens in H11's rows and in the path, and `mas_expand_plain`'s path,
    which is `mas_backtrack`'s."""
    tx, ty = torch.from_numpy(t_x), torch.from_numpy(t_y)
    foreign = bits * 3
    foreign[:, :, 0] = 1
    for given_bits in (bits, foreign):
        path, rows, _ = emulate(given_bits.numpy(), t_x, t_y, F, S, fetch)
        want = mas_walk_idx_plain(given_bits, tx, ty)
        np.testing.assert_array_equal(rows, want.numpy())
        tokens = np.where(path.any(1), path.argmax(1) + 1, 0)
        np.testing.assert_array_equal(tokens, want.numpy())
        np.testing.assert_array_equal(
            path, mas_expand_plain(want, bits.shape[2]).numpy())
        np.testing.assert_array_equal(
            path, mas_backtrack(given_bits, tx, ty).numpy())


@pytest.mark.parametrize("plan", [(64, 4), (16, 4), (4, 4), (2, 4), (1, 2),
                                  (1, 1)])
@settings(max_examples=20, deadline=None)
@given(batch=tie_batches())
def test_ring_walk_equals_the_plain_walk(plan, batch):
    """Chunks of F frames through S stages, under ties, on plain and on
    foreign bits, with the contract's edge items; each fetch form the
    shape allows (bulk only where its chunks are 16-byte multiples)."""
    value, t_x, t_y = batch
    bits = mas_bits(*(torch.from_numpy(a) for a in batch))
    T_x, T_y = value.shape[1], value.shape[2]
    F, S = plan
    fetches = ["bytes"] + (["async"] if T_x % 4 == 0 else []) + (
        ["bulk"] if T_x * T_y % 16 == 0 and F * T_x % 16 == 0 else [])
    for fetch in fetches:
        check_ring_walk(bits, t_x, t_y, F, S, fetch)


# Ring wraps at F = 4, S = 4 (16 frames a lap): t_y within one chunk, one
# lap exactly, past a lap with a partial top chunk, several laps; T_x % 4
# != 0 beside 4-byte columns; the last item invalid (t_x > t_y).
@pytest.mark.parametrize("T_x,ty", [(5, 3), (8, 4), (5, 16), (8, 16),
                                    (7, 17), (12, 30), (9, 45), (16, 48)])
def test_ring_wraps(T_x, ty):
    rng = np.random.default_rng(T_x * 100 + ty)
    T_y = ty + 3
    value = rng.integers(-2, 3, (3, T_x, T_y)).astype(np.float32)
    t_x = np.array([T_x, min(T_x, ty), T_x], np.int32)
    t_y = np.array([ty, T_y, min(T_x, ty) - 1], np.int32)
    bits = mas_bits(*(torch.from_numpy(a) for a in (value, t_x, t_y)))
    for fetch in ("bytes", "async", "bulk"):
        if fetch == "async" and T_x % 4 or fetch == "bulk" and (
                T_x * T_y % 16 or 4 * T_x % 16):
            continue
        check_ring_walk(bits, t_x, t_y, 4, 4, fetch)


# H11's index rows from a row base at each 4-byte offset of a 16-byte
# line (row b starts at idx_base + 4 b T_y), with chunks of 128, 16, 4, 2
# and 1 frames; T_y odd and even. Items: full length, ragged, t_x > t_y,
# t_x = 0.
@pytest.mark.parametrize("idx_base", [0, 4, 8, 12])
@pytest.mark.parametrize("T_x,T_y,F", [(45, 300, 128), (8, 61, 16),
                                       (20, 301, 4), (6, 37, 2), (5, 13, 1)])
def test_idx_rows_from_any_alignment(T_x, T_y, F, idx_base):
    """The plain walk's tokens + 1, zeros from t_y on and on the invalid
    items, every frame written once over garbage; four-frame stores only
    at 16-byte aligned addresses, and some wherever a chunk holds four
    frames."""
    rng = np.random.default_rng(T_y * 16 + idx_base)
    value = rng.integers(-2, 3, (4, T_x, T_y)).astype(np.float32)
    t_x = np.array([T_x, T_x // 2 + 1, T_x, 0], np.int32)
    t_y = np.array([T_y, T_y - 5, T_x - 1, T_y // 2], np.int32)
    tx, ty = torch.from_numpy(t_x), torch.from_numpy(t_y)
    bits = mas_bits(torch.from_numpy(value), tx, ty)
    _, rows, quads = emulate(bits.numpy(), t_x, t_y, F, 4, "bytes",
                             idx_base)
    want = mas_walk_idx_plain(bits, tx, ty).numpy()
    np.testing.assert_array_equal(rows, want)
    assert not want[2:].any() and not want[1, t_y[1]:].any()
    assert (quads > 0) == (F >= 4)
