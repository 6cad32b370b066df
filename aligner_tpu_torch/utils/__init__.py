"""Length and mask helpers, alignment metrics and device-time
measurement: the JAX package's `aligner_tpu.utils` names."""
from .eval import boundaries_from_durations, boundary_f1, frame_accuracy
from .masks import lattice_mask, lengths_from_lattice_mask, sequence_mask
from .profiling import device_op_durations, measure_device_time

__all__ = ["boundaries_from_durations", "boundary_f1",
           "device_op_durations", "frame_accuracy", "lattice_mask",
           "lengths_from_lattice_mask", "measure_device_time",
           "sequence_mask"]
