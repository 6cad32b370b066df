"""H4, the pause-aware Viterbi (csrc/skip_dp.cu): reads the state
lattice, writes the frame-major float32 path [B, T_y, 2 T_x + 1].

Work a call, as `chip_smoke.py` counts it: the live cells of the
batch's valid items, each read once per input lattice, the output
written once, 5 operations and 0 special-function results a cell.
"""
from harness.peaks import live_cells

TRACE_NAMES = ('mas_skip_kernel',)


def work(batch: dict) -> dict:
    B, T_x = batch["tokens"].shape
    T_y = batch["mel"].shape[1]
    T = 2 * T_x + 1
    return {"cells": live_cells(batch["text_lengths"], batch["mel_lengths"],
                               skip=True),
            "in_lattices": 1, "out_bytes": 4 * B * T_y * T,
            "ops_per_cell": 5, "sfu_per_cell": 0}
