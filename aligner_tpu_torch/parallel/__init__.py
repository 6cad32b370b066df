"""Data, tensor and sequence parallelism over a process mesh (port of
aligner_tpu/parallel): `make_mesh` and the sharding rules
(`parallel/mesh.py`), the column-parallel layers (`parallel/tensor.py`),
the batch-wide statistics of a data-parallel step (`parallel/data.py`) and
sequence-parallel MAS (`parallel/sequence.py`)."""
from .mesh import (batch_sharding, make_mesh, param_spec, replicated,
                   shard_params)
from .sequence import mas_sequence_parallel

__all__ = ["batch_sharding", "make_mesh", "mas_sequence_parallel",
           "param_spec", "replicated", "shard_params"]
