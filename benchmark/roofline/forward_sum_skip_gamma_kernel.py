"""H6, the pause-aware beta sweep with the posterior
(csrc/skip_dp.cu): reads the state lattice and the alphas, writes the
posterior [B, T_y, T_s]. Two logaddexp and the posterior's expf.

Work a call, as `chip_smoke.py` counts it: the live cells of the
batch's valid items, each read once per input lattice, the output
written once, 21 operations and 5 special-function results a cell.
"""
from harness.peaks import live_cells

TRACE_NAMES = ('forward_sum_skip_gamma_kernel',)


def work(batch: dict) -> dict:
    B, T_x = batch["tokens"].shape
    T_y = batch["mel"].shape[1]
    T = 2 * T_x + 1
    return {"cells": live_cells(batch["text_lengths"], batch["mel_lengths"],
                               skip=True),
            "in_lattices": 2, "out_bytes": 4 * B * T_y * T,
            "ops_per_cell": 21, "sfu_per_cell": 5}
