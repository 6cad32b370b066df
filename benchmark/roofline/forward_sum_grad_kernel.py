"""H3, the beta sweep with the posterior (csrc/forward_sum.cu): reads
the lattice and the alphas, writes the posterior [B, T_y, T_x].
A logaddexp's expf and log1pf, and the posterior's expf.

Work a call, as `chip_smoke.py` counts it: the live cells of the
batch's valid items, each read once per input lattice, the output
written once, 13 operations and 3 special-function results a cell.
"""
from harness.peaks import live_cells

TRACE_NAMES = ('forward_sum_grad_kernel',)


def work(batch: dict) -> dict:
    B, T_x = batch["tokens"].shape
    T_y = batch["mel"].shape[1]
    T = T_x
    return {"cells": live_cells(batch["text_lengths"], batch["mel_lengths"],
                               skip=False),
            "in_lattices": 2, "out_bytes": 4 * B * T_y * T,
            "ops_per_cell": 13, "sfu_per_cell": 3}
