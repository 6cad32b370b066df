"""Data pipeline: bucketing, the synthetic corpus, device prefetch."""
from .batching import BucketSpec, bucket_batches, pad_batch, round_up
from .prefetch import prefetch_to_device
from .synthetic import (SyntheticConfig, duration_accuracy, make_corpus,
                        prototypes)

__all__ = ["BucketSpec", "SyntheticConfig", "bucket_batches",
           "duration_accuracy", "make_corpus", "pad_batch",
           "prefetch_to_device", "prototypes", "round_up"]
