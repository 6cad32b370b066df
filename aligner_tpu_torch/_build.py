"""Build and load the package's CUDA kernels.

`csrc/*.cu` compile with `nvcc` for Hopper (`sm_90a`), one `nvcc` process
per source, all started together, and link into one shared library with a
plain C interface, loaded with `ctypes`. The build runs at first use, is
cached under `_build/` by a hash of the sources and flags, and is never
attempted at import time: the CPU tests import every module of the
package on machines with no `nvcc`.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check` turns a non-zero code into an exception,
since a refused launch (too many threads, too much shared memory) never
runs and a later synchronise would not report it.
"""
from __future__ import annotations

import collections
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD_DIR = os.path.join(_HERE, "_build")

# No --use_fast_math: MAS paths are held bit-identical to the reference
# and the forward-sum loss to about 1e-5, both of which need precise
# expf/log1pf and IEEE adds.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_F32 = ctypes.c_float
_SIGNATURES = {
    "mas_launch": [_P, _I64, _I64, _I64, _P, _P, _P, _P, _I64, _I64, _I64,
                   _P, _P, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _I32,
                   _F32, _P],
    "forward_sum_alpha_launch": [_P, _I64, _I64, _I64, _P, _P, _P, _I32,
                                 _I32, _I32, _I32, _I32, _I32, _P],
    "forward_sum_grad_launch": [_P, _I64, _I64, _I64, _P, _I64, _I64, _I64,
                                _P, _P, _P, _P, _I64, _I64, _I64, _I32, _I32,
                                _I32, _I32, _I32, _I32, _P],
    "mas_skip_launch": [_P, _I64, _I64, _I64, _P, _P, _P, _P, _I64, _I64,
                        _I64, _I32, _I32, _I32, _I32, _I32, _I32, _I32,
                        _I32, _F32, _F32, _P],
    "forward_sum_skip_alpha_launch": [_P, _I64, _I64, _I64, _P, _P, _P, _I32,
                                      _I32, _I32, _I32, _I32, _I32, _F32,
                                      _P],
    "forward_sum_skip_gamma_launch": [_P, _I64, _I64, _I64, _P, _I64, _I64,
                                      _I64, _P, _P, _P, _P, _I64, _I64, _I64,
                                      _I32, _I32, _I32, _I32, _I32, _I32,
                                      _F32, _P],
    "mobo_alpha_launch": [_P, _I64, _I64, _I64, _P, _P, _I32, _I32, _I32,
                          _I32, _I32, _I32, _P],
    "mobo_bp_launch": [_P, _I64, _I64, _I64, _P, _P, _P, _P, _I32, _I32,
                       _I32, _I32, _I32, _I32, _P],
    "mobo_beta_launch": [_P, _I64, _I64, _I64, _P, _P, _P, _I32, _I32, _I32,
                         _I32, _I32, _I32, _P],
    "mas_walk_stage_launch": [_P, _P, _P, _P, _I64, _I64, _I64, _I32, _I32,
                              _I32, _I32, _I32, _I32, _I32, _P],
    "mas_walk_idx_launch": [_P, _P, _P, _P, _I32, _I32, _I32, _I32, _I32,
                            _I32, _I32, _P],
    "mas_expand_launch": [_P, _P, _I64, _I64, _I64, _I32, _I32, _I32, _P],
    "mas_bits_chains_launch": [_P, _I64, _I64, _I64, _P, _P, _P, _P, _I32,
                               _I32, _I32, _I32, _I32, _I32, _I32, _I32,
                               _I32, _F32, _P],
    "mas_walk_chains_launch": [_P, _P, _P, _P, _I64, _I64, _I64, _I32, _I32,
                               _I32, _I32, _I32, _I32, _I32, _I32, _P],
}

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
# Build record of this process: seconds spent in nvcc (0.0 when the
# library came from the cache) and nvcc's resource report.
BUILD_INFO: dict = {}

# Kernel launches by kernel name. A wrapper adds one where it launches
# its kernel, and nowhere else.
LAUNCHES: collections.Counter = collections.Counter()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels cannot be built")
    return found


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu"))
                  + glob.glob(os.path.join(_CSRC, "*.cuh")))


def _tag(sources: list[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc_jobs(cmds: list[list[str]]) -> str:
    """Run the nvcc commands at once, wait for all of them, and return
    their output; raise on the first that failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    results = [(cmd, *proc.communicate(), proc.returncode)
               for cmd, proc in zip(cmds, procs)]
    for cmd, out, err, code in results:
        if code != 0:
            raise RuntimeError(f"nvcc failed ({code}):\n{' '.join(cmd)}"
                               f"\n{out}{err}")
    return "".join(out + err for _, out, err, _ in results)


def _compile(sources: list[str], so: str) -> str:
    """Compile each .cu into an object, one nvcc per source, all at once;
    link them into `so` and return nvcc's output. The work happens in a
    temporary directory per process and the library is installed
    atomically, so processes building at once never load a half-written
    library."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        cus = [src for src in sources if src.endswith(".cu")]
        objs = [os.path.join(tmp, os.path.basename(src) + ".o")
                for src in cus]
        log = _nvcc_jobs([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                          for src, obj in zip(cus, objs)])
        out = os.path.join(tmp, os.path.basename(so))
        log += _nvcc_jobs([[nvcc, "-shared", *NVCC_FLAGS[:2], "-o", out,
                            *objs]])
        os.replace(out, so)
    return log


def load_library() -> ctypes.CDLL:
    """Compile the kernels if needed, load them and declare their C
    signatures. Raises RuntimeError when nvcc fails."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        sources = _sources()
        os.makedirs(_BUILD_DIR, exist_ok=True)
        so = os.path.join(_BUILD_DIR, f"libaligner_kernels_{_tag(sources)}.so")
        BUILD_INFO.update(seconds=0.0, log="")
        if not os.path.exists(so):
            t0 = time.perf_counter()
            log = _compile(sources, so)
            BUILD_INFO.update(seconds=time.perf_counter() - t0, log=log)
        lib = ctypes.CDLL(so)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.aligner_cuda_error_string.argtypes = [ctypes.c_int]
        lib.aligner_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
        return lib


def build_probe(name: str, source: str) -> ctypes.CDLL:
    """Compile a probe's own CUDA `source` (nothing of the package's
    library) into `_build/<name>.so` and load it."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    src = os.path.join(_BUILD_DIR, f"{name}.cu")
    lib_path = os.path.join(_BUILD_DIR, f"{name}.so")
    with open(src, "w") as f:
        f.write(source)
    subprocess.run([_nvcc(), *NVCC_FLAGS[:4], "-shared", "-Xcompiler",
                    "-fPIC", "-o", lib_path, src], check=True,
                   capture_output=True)
    return ctypes.CDLL(lib_path)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.aligner_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def card_label(index: int = 0) -> str:
    """Name and power limit of card `index`, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them: what every time measured on the card is written beside."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(index)],
        capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def device_label(device) -> str:
    """`card_label` of a CUDA device ("cuda", "cuda:1" or its
    torch.device); the name of any other device."""
    name = str(device)
    if name.startswith("cuda"):
        return card_label(int(name.partition(":")[2] or 0))
    return name


def kernel_launches() -> dict[str, int]:
    """Launch counts by kernel name since the last reset."""
    return dict(LAUNCHES)


def reset_kernel_launches() -> None:
    LAUNCHES.clear()
