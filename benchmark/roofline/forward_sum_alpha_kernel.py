"""H2, the forward-sum alpha sweep (csrc/forward_sum.cu): reads the
lattice, writes the alpha lattice [T_y, B, T_x] and the final column.
One expf and one log1pf a logaddexp.

Work a call, as `chip_smoke.py` counts it: the live cells of the
batch's valid items, each read once per input lattice, the output
written once, 8 operations and 2 special-function results a cell.
"""
from harness.peaks import live_cells

TRACE_NAMES = ('forward_sum_alpha_kernel',)


def work(batch: dict) -> dict:
    B, T_x = batch["tokens"].shape
    T_y = batch["mel"].shape[1]
    T = T_x
    return {"cells": live_cells(batch["text_lengths"], batch["mel_lengths"],
                               skip=False),
            "in_lattices": 1, "out_bytes": 4 * B * T_y * T + 4 * B * T,
            "ops_per_cell": 8, "sfu_per_cell": 2}
