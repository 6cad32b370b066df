"""Monotonic Alignment Search: the drop-in `maximum_path(value, mask)` API
and the aligner's frame-major hard path (port of aligner_tpu/ops/mas.py).

The route follows the tensor: a CUDA tensor runs kernel H1
(`ops/mas_kernel.py`, `csrc/mas.cu`), a CPU tensor its plain PyTorch
version; `maximum_path(..., implementation="cpp")` runs the C++ host
oracle (`native/`) when the caller asks for it. Paths are bit-identical to
the reference Cython kernel (monotonic_align/core.pyx:9-45), ties
included; items with t_x > t_y or t_x = 0 get an all-zero path.
"""
from __future__ import annotations

import torch

from ..utils.masks import lengths_from_lattice_mask
from .mas_kernel import mas_path
from .mas_reference import MAX_NEG_VAL


def mas_path_frame_major(logp: torch.Tensor, t_x, t_y) -> torch.Tensor:
    """Hard MAS path in the aligner's frame-major layout.

    logp: [B, T_y, T_x] log-prob lattice (log-attention + prior); returns
    f32 0/1 path [B, T_y, T_x]. The kernel reads the lattice through its
    strides, so neither side is transposed in memory.
    """
    return mas_path(logp.to(torch.float32).transpose(1, 2), t_x, t_y,
                    frame_major=True)


IMPLEMENTATIONS = ("auto", "cpp")


def maximum_path(value: torch.Tensor, mask: torch.Tensor, *,
                 implementation: str = "auto",
                 max_neg_val: float = MAX_NEG_VAL) -> torch.Tensor:
    """Drop-in MAS API: `maximum_path(value, mask) -> path`.

    Same contract as the reference wrapper (monotonic_align/__init__.py:
    6-21): value and mask are [b, t_x, t_y]; per-item lengths come from
    the mask (t_x = mask.sum(1)[:, 0], t_y = mask.sum(2)[:, 0]); the
    returned 0/1 path has the dtype and device of `value`.

    implementation: "auto" routes by device (kernel H1 on a CUDA tensor,
    its plain version on a CPU tensor). "cpp" copies the masked lattice to
    the host, runs the C++ oracle (`native.maximum_path_cpp`) and copies
    the path back: the explicit host route, as in the JAX package, for
    conformance checks and the single-utterance corner. It raises
    ValueError unless 1 <= t_x <= t_y for every item, where "auto" gives
    such an item an all-zero path. "auto" never routes to it.

    max_neg_val: sentinel that excludes infeasible DP transitions, the
    reference's one knob (core.pyx:40, default -1e9). It must lie far
    below every real lattice value.
    """
    if value.ndim != 3 or mask.ndim != 3:
        raise ValueError(
            f"maximum_path expects [b, t_x, t_y] value and mask, got "
            f"value.shape={tuple(value.shape)}, mask.shape={tuple(mask.shape)}")
    if value.shape != mask.shape:
        raise ValueError(f"value and mask shapes differ: "
                         f"{tuple(value.shape)} vs {tuple(mask.shape)}")
    if implementation not in IMPLEMENTATIONS:
        raise ValueError(
            f"unknown implementation {implementation!r}: the port routes "
            "by device ('auto') or runs the host oracle ('cpp'); 'lax' "
            "and 'pallas' are routes of the JAX package")
    if implementation == "cpp":
        from ..native import maximum_path_cpp
        path = maximum_path_cpp(value, mask, max_neg_val=max_neg_val)
        return torch.from_numpy(path).to(device=value.device,
                                         dtype=value.dtype)
    t_x, t_y = lengths_from_lattice_mask(mask)
    # The reference multiplies by the mask first (__init__.py:11); in-band
    # cells are unchanged by it, so this only sanitises padding.
    v = (value * mask).to(torch.float32)
    return mas_path(v, t_x, t_y, max_neg_val=max_neg_val).to(value.dtype)
