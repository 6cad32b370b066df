"""The launch plan of the skip Viterbi H4
(`ops/skip_dp_kernel.py:_skip_viterbi_plan`), checked on the CPU: the
place of the move planes, the fetch, a shared-memory layout the card would
refuse, or a plan the kernel was not built for shows here before any
launch.

    python -m pytest -q tests/test_torch_skip_viterbi_plan.py
"""
import os
import re

import pytest

from aligner_tpu_torch.ops.forward_sum_kernel import MAX_THREADS
from aligner_tpu_torch.ops.skip_dp_kernel import (MAX_SMEM,
                                                  SKIP_VITERBI_PLANS,
                                                  _skip_viterbi_plan,
                                                  _skip_viterbi_smem)

SKIP_SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "aligner_tpu_torch", "csrc", "skip_dp.cu")

# (T_s, T_y): the pause lattices of the paths and the card tests (257 and
# 1041 states), the edges of each cell count, a single frame, and lattices
# whose planes fit in shared memory only behind the shallow ring, or not
# at all.
SHAPES = ((3, 1), (25, 61), (257, 300), (257, 1024), (257, 2048),
          (257, 3000), (257, 4000), (1023, 10), (1024, 256), (1025, 256),
          (1041, 700), (1041, 1200), (2048, 100), (2049, 100), (4096, 30),
          (4097, 30), (8192, 10), (8192, 1024))


@pytest.mark.parametrize("frames_contiguous", [True, False])
@pytest.mark.parametrize("T_s,T_y", SHAPES)
def test_plan_covers_the_column_within_the_card(T_s, T_y, frames_contiguous):
    threads, cells, ring, planes, fetch, smem = _skip_viterbi_plan(
        T_s, T_y, frames_contiguous)
    assert (cells, ring, planes, fetch) in SKIP_VITERBI_PLANS
    assert threads * cells >= T_s                 # every state has a thread
    assert threads % 32 == 0 and 32 <= threads <= MAX_THREADS
    assert (threads - 32) * cells < T_s           # no warp without a state
    assert ring >= (24 if fetch == "tiles" else 2)   # fetched ahead
    assert ring & (ring - 1) == 0                 # slots by a mask
    assert fetch == "rows" or frames_contiguous
    pitch = threads * cells
    plane_bytes = 8 * (pitch // 32) * T_y if planes == "shared" else 0
    assert smem == plane_bytes + 4 * ring * (pitch + 4) \
        + 8 * (pitch + 2) <= MAX_SMEM
    # the fewest cells that cover the column, and the first plan of that
    # count and a fetch the lattice takes that fits
    fewest = min(c for c, *_ in SKIP_VITERBI_PLANS
                 if c * MAX_THREADS >= T_s)
    assert cells == fewest
    for c, r, p, f in SKIP_VITERBI_PLANS[:SKIP_VITERBI_PLANS.index(
            (cells, ring, planes, fetch))]:
        if c == cells and (f == "rows" or frames_contiguous):
            assert _skip_viterbi_smem(
                pitch, r, T_y if p == "shared" else 0) > MAX_SMEM


@pytest.mark.parametrize("T_s,T_y,frames_contiguous,want", [
    # phase 7's batch: 73.7 KB of planes
    (257, 1024, True, (288, 1, 32, "shared", "tiles")),
    (257, 1024, False, (288, 1, 8, "shared", "rows")),
    # the card test's wide case: the planes behind the shallow ring
    (1041, 700, True, (544, 2, 4, "shared", "rows")),
    (1041, 700, False, (544, 2, 4, "shared", "rows")),
    # phase 11's wide case
    (1041, 1200, True, (544, 2, 8, "global", "rows")),
    (257, 4000, True, (288, 1, 32, "global", "tiles"))])
def test_plans_of_the_paths(T_s, T_y, frames_contiguous, want):
    """The planes of 257 x 1024 and 1041 x 700 fit in shared memory, those
    of 1041 x 1200 do not; a state-major lattice of up to 1024 states is
    fetched in tiles, a frame-major one in rows."""
    assert _skip_viterbi_plan(T_s, T_y, frames_contiguous)[:5] == want


def test_every_plan_group_has_a_plan_that_always_fits():
    """The device-memory plan of each cell count and fetch fits at its
    widest column, so a plan exists for every T_y."""
    for cells, fetch in {(c, f) for c, _, _, f in SKIP_VITERBI_PLANS}:
        rings = [r for c, r, p, f in SKIP_VITERBI_PLANS
                 if (c, p, f) == (cells, "global", fetch)]
        assert len(rings) == 1
        assert _skip_viterbi_smem(cells * MAX_THREADS, rings[0], 0) \
            <= MAX_SMEM
        plan = _skip_viterbi_plan(cells * MAX_THREADS, 100000,
                                  fetch == "tiles")
        assert plan[3:5] == ("global", fetch)


def test_plans_match_the_kernels_built():
    """Every plan of SKIP_VITERBI_PLANS is one that `with_skip_plan`
    dispatches, and no other: a plan the kernel was not built for would
    be refused."""
    with open(SKIP_SOURCE) as f:
        source = f.read()
    lines = re.findall(
        r"cells == (\d+) && ring == (\d+) && (!?)shared && (!?)tiles\)"
        r"\s*return f\(SkipPlan<(\d+), (\d+), (true|false), (true|false)>",
        source)
    built = set()
    for cells, ring, not_shared, not_tiles, c2, r2, shared, tiles in lines:
        assert (cells, ring) == (c2, r2)
        assert (not_shared == "") == (shared == "true")
        assert (not_tiles == "") == (tiles == "true")
        built.add((int(cells), int(ring),
                   "shared" if shared == "true" else "global",
                   "tiles" if tiles == "true" else "rows"))
    assert len(lines) == len(built) == len(SKIP_VITERBI_PLANS)
    assert built == set(SKIP_VITERBI_PLANS)


def test_columns_past_the_widest_plan_raise():
    assert _skip_viterbi_plan(8192, 1, False)[1] == 8
    with pytest.raises(ValueError, match="at most 8192 states"):
        _skip_viterbi_plan(8193, 1, True)
