"""Published peaks of one NVIDIA H100 SXM5 (80 GB HBM3), at its full
power limit of 700 W. A card set below it runs slower under load, so
every share of a peak is printed beside the card's power limit.

* FLOP/s, dense, without sparsity: NVIDIA H100 Tensor Core GPU data
  sheet (SXM5 column): FP32 67 TFLOP/s (outside the tensor cores, which
  TF32 off leaves), BF16 989 TFLOP/s;
* HBM3 bandwidth: the same data sheet, 3.35 TB/s;
* special-function results (expf, logf, log1pf): 16 a clock an SM at
  compute capability 9.0 (CUDA C++ Programming Guide, "Arithmetic
  Instructions" throughput table), times 132 SMs and the 1980 MHz
  maximum boost clock of the SXM5 part.
"""
import numpy as np

FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # by compute dtype
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SFU_PER_S = 16 * 132 * 1.98e9


def kernel_bound_s(cells: int, in_lattices: int, out_bytes: int,
                   ops_per_cell: int, sfu_per_cell: int = 0):
    """(seconds, by): the least time the card could take for one call of
    a lattice kernel, copied from `chip_smoke.py`'s `bound`. The largest
    of: the bytes it must move (each live cell read once per float32
    input lattice, each output byte written once) over HBM's rate; its
    operations on the live cells over the float32 rate; its expf, logf
    and log1pf over the special-function rate."""
    terms = {"bytes": (4 * in_lattices * cells + out_bytes)
             / HBM_BYTES_PER_S,
             "operations": ops_per_cell * cells / FP32_OPS_PER_S,
             "sfu": sfu_per_cell * cells / SFU_PER_S}
    by = max(terms, key=terms.get)
    return terms[by], by


def live_cells(t_x, t_y, skip: bool = False) -> int:
    """Lattice cells that the valid items (1 <= t_x <= t_y) of a ragged
    batch need: t_x rows, or 2 t_x + 1 states with `skip`, by t_y frames
    (`chip_smoke.py`'s `live_cells`, on numpy lengths)."""
    t_x = np.asarray(t_x, np.int64)
    t_y = np.asarray(t_y, np.int64)
    valid = (t_x >= 1) & (t_x <= t_y)
    rows = 2 * t_x + 1 if skip else t_x
    return int((rows * t_y * valid).sum())
