"""The launch plan of the posterior sweeps H3 and H6 and the forward
sweeps H2 and H5 (`ops/forward_sum_kernel.py:_sweep_plan`), checked on
the CPU: what the card would refuse, or what would leave a cell
unswept, shows here before any launch.

    python -m pytest -q tests/test_torch_sweep_plan.py
"""
import os
import re

import pytest

from aligner_tpu_torch.ops.forward_sum_kernel import (MAX_THREADS,
                                                      SWEEP_PLANS,
                                                      _forward_smem,
                                                      _sweep_plan)

MAX_SMEM = 232448            # a block's opt-in shared memory on the H100

SWEEP_HEADER = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "aligner_tpu_torch", "csrc",
    "posterior_sweep.cuh")

# Column widths: T_x of the tests and the phase-7 shapes, T_s = 257 and
# 1041 of the pause lattices, the widest column of each plan and one past.
WIDTHS = (1, 12, 31, 32, 33, 128, 257, 1024, 1025, 1041, 1100, 2048, 2049,
          3072, 3073, 4096, 4097, 6144, 6145, 8192)


@pytest.mark.parametrize("T", WIDTHS)
def test_plan_covers_the_column_within_the_card(T):
    threads, cells, ring, smem = _sweep_plan(T)
    assert threads * cells >= T                  # every cell has a thread
    assert threads % 32 == 0 and 32 <= threads <= MAX_THREADS
    assert ring >= 2                  # a frame fetched a step ahead or more
    pitch = threads * cells
    assert smem == 4 * (2 * pitch + 2 * ring * pitch) <= MAX_SMEM
    # the first plan whose cells cover the column, and no warp without a
    # cell
    index = SWEEP_PLANS.index((cells, ring))
    assert index == 0 or SWEEP_PLANS[index - 1][0] * MAX_THREADS < T
    assert (threads - 32) * cells < T


@pytest.mark.parametrize("pad", [1, 2])
@pytest.mark.parametrize("T", WIDTHS)
def test_forward_layout_fits_at_every_width(T, pad):
    """H2 (one pad cell) and H5 (two, for the skip arm's s - 2) take the
    same plan and hold one lp row a slot: their layout fits too."""
    threads, cells, ring, smem = _sweep_plan(T)
    pitch = threads * cells
    assert _forward_smem(pitch, ring, pad) \
        == 4 * (ring * pitch + 2 * (pitch + pad)) <= smem <= MAX_SMEM


@pytest.mark.parametrize("T", (1, 128, 257, 1041))
def test_columns_of_the_paths_take_the_deepest_ring(T):
    """H3's 128 and H6's 257 take one cell a thread, T_s = 1041 two; each
    a ring of 8 frames and as few threads as hold the column."""
    threads, cells, ring, _ = _sweep_plan(T)
    assert (cells, ring) == ((1, 8) if T <= MAX_THREADS else (2, 8))
    assert threads == 32 * -(-T // (32 * cells))


def test_plans_match_the_kernels_built():
    """Every pair of SWEEP_PLANS is one that `with_plan` dispatches, and
    no other: a plan the kernels were not built for would be refused."""
    with open(SWEEP_HEADER) as f:
        built = {tuple(map(int, pair)) for pair in re.findall(
            r"cells == (\d+) && ring == (\d+)\) return f\(Plan<\1, \2>",
            f.read())}
    assert built == set(SWEEP_PLANS)


def test_columns_past_the_widest_plan_raise():
    widest = SWEEP_PLANS[-1][0] * MAX_THREADS
    assert _sweep_plan(widest)[1] == SWEEP_PLANS[-1][0]
    with pytest.raises(ValueError, match="at most 8192 cells"):
        _sweep_plan(widest + 1)
