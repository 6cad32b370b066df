"""H5, the pause-aware alpha sweep (csrc/skip_dp.cu): reads the state
lattice, writes the alphas [T_y, B, T_s] and the final column. Two
logaddexp a cell.

Work a call, as `chip_smoke.py` counts it: the live cells of the
batch's valid items, each read once per input lattice, the output
written once, 16 operations and 4 special-function results a cell.
"""
from harness.peaks import live_cells

TRACE_NAMES = ('forward_sum_skip_alpha_kernel',)


def work(batch: dict) -> dict:
    B, T_x = batch["tokens"].shape
    T_y = batch["mel"].shape[1]
    T = 2 * T_x + 1
    return {"cells": live_cells(batch["text_lengths"], batch["mel_lengths"],
                               skip=True),
            "in_lattices": 1, "out_bytes": 4 * B * T_y * T + 4 * B * T,
            "ops_per_cell": 16, "sfu_per_cell": 4}
