"""aligner_tpu_torch: the text-to-speech aligner in PyTorch, with CUDA
kernels written for Hopper (sm_90a).

A port of the JAX package `aligner_tpu`, which stays the reference: module
paths mirror it (`ops/mas.py`, `models/ota.py`, `serving.py`, ...) and
public functions keep its layouts. Each dynamic programme that
`aligner_tpu` runs as a Pallas kernel on the TPU is a CUDA kernel here
(`csrc/`), built with nvcc at first use. A CUDA tensor launches the kernel
or raises; a CPU tensor runs the kernel's plain PyTorch version.

This package never imports jax.
"""
from ._build import kernel_launches, reset_kernel_launches
from .models.mobo import MoBoAligner, MoBoConfig
from .models.ota import OTAAligner, OTAConfig
from .models.romo import RoMoAligner, RoMoConfig
from .ops.mas import maximum_path
from .serving import BatchAligner, SkipBatchAligner

__version__ = "0.1.0"
__all__ = ["BatchAligner", "MoBoAligner", "MoBoConfig", "OTAAligner",
           "OTAConfig", "RoMoAligner", "RoMoConfig", "SkipBatchAligner",
           "kernel_launches", "maximum_path", "reset_kernel_launches",
           "__version__"]
