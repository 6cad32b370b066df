"""H1, MAS Viterbi (csrc/mas.cu): reads the lattice, writes the
frame-major float32 path [B, T_y, T_x] whole.

Work a call, as `chip_smoke.py` counts it: the live cells of the
batch's valid items, each read once per input lattice, the output
written once, 3 operations and 0 special-function results a cell.
"""
from harness.peaks import live_cells

TRACE_NAMES = ('mas_kernel', 'mas_wide_kernel')


def work(batch: dict) -> dict:
    B, T_x = batch["tokens"].shape
    T_y = batch["mel"].shape[1]
    T = T_x
    return {"cells": live_cells(batch["text_lengths"], batch["mel_lengths"],
                               skip=False),
            "in_lattices": 1, "out_bytes": 4 * B * T_y * T,
            "ops_per_cell": 3, "sfu_per_cell": 0}
