"""Lazy g++ build and ctypes bindings for the C++ MAS oracle (port of
aligner_tpu/native/build.py).

The library is cached under `native/_build/` (or the directory named by
`ALIGNER_TPU_TORCH_NATIVE_CACHE`) by a hash of the source, so an edit
rebuilds it and concurrent builders never load a half-written file.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np
import torch

from ..ops.mas_reference import MAX_NEG_VAL

_SRC = os.path.join(os.path.dirname(__file__), "mas_cpu.cpp")
_LOCK = threading.Lock()
_LIB = None


def _build_dir() -> str:
    d = os.environ.get("ALIGNER_TPU_TORCH_NATIVE_CACHE",
                       os.path.join(os.path.dirname(__file__), "_build"))
    os.makedirs(d, exist_ok=True)
    return d


def load_mas_cpu() -> ctypes.CDLL:
    """Compile (if needed) and load the native library."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        with open(_SRC, "rb") as f:
            tag = hashlib.sha256(f.read()).hexdigest()[:16]
        so = os.path.join(_build_dir(), f"mas_cpu_{tag}.so")
        if not os.path.exists(so):
            # A temporary file per process: concurrent builders (other
            # processes; _LOCK only serialises threads) each compile to
            # their own file and install it atomically with os.replace.
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_build_dir())
            os.close(fd)
            try:
                subprocess.run(
                    ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                     "-march=native", _SRC, "-o", tmp, "-lpthread"],
                    check=True, capture_output=True)
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(so)
        lib.mas_maximum_path_batch.restype = ctypes.c_int
        lib.mas_maximum_path_batch.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_float, ctypes.c_int32,
        ]
        _LIB = lib
        return lib


def _host_float32(a) -> np.ndarray:
    """A float32 numpy copy of a tensor (any device or dtype) or array."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32).numpy()
    return np.asarray(a, dtype=np.float32)


def maximum_path_cpp(value, mask, n_threads: int = 0, *,
                     max_neg_val: float = MAX_NEG_VAL) -> np.ndarray:
    """Batched MAS on the host through the C++ oracle.

    value, mask: [b, t_x, t_y] tensors (on any device) or arrays; lengths
    come from the mask as in the reference wrapper (monotonic_align/
    __init__.py:18-19). The caller's lattice is not modified. Returns an
    int32 numpy path. n_threads=0 uses every hardware thread. Raises
    ValueError unless 1 <= t_x <= t_y for every item.
    """
    lib = load_mas_cpu()
    value, mask = _host_float32(value), _host_float32(mask)
    if value.ndim != 3 or value.shape != mask.shape:
        raise ValueError(f"expected [b, t_x, t_y] value and mask of one "
                         f"shape, got {value.shape} and {mask.shape}")
    value = np.ascontiguousarray(value * mask, dtype=np.float32)
    t_xs = np.ascontiguousarray(mask.sum(axis=1)[:, 0], dtype=np.int32)
    t_ys = np.ascontiguousarray(mask.sum(axis=2)[:, 0], dtype=np.int32)
    b, t_x_max, t_y_max = value.shape
    path = np.zeros((b, t_x_max, t_y_max), dtype=np.int32)
    rc = lib.mas_maximum_path_batch(
        value.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        path.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        t_xs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        t_ys.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        b, t_x_max, t_y_max, np.float32(max_neg_val), n_threads)
    if rc != 0:
        raise ValueError(
            "mas_maximum_path_batch: invalid lengths (need 1 <= t_x <= t_y "
            "per item; derived from the mask)")
    return path
