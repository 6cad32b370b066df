"""Data pipeline: the wav corpus loader, tokenizers, TextGrids,
bucketing, the synthetic corpus, device prefetch."""
from .batching import BucketSpec, bucket_batches, pad_batch, round_up
from .files import load_corpus, load_metadata, read_wav
from .prefetch import prefetch_to_device
from .synthetic import (SyntheticConfig, duration_accuracy, make_corpus,
                        prototypes)
from .text import CharTokenizer, PhoneTokenizer
from .textgrid import durations_to_intervals, write_textgrid

__all__ = ["BucketSpec", "CharTokenizer", "PhoneTokenizer",
           "SyntheticConfig", "bucket_batches", "duration_accuracy",
           "durations_to_intervals", "load_corpus", "load_metadata",
           "make_corpus", "pad_batch", "prefetch_to_device", "prototypes",
           "read_wav", "round_up", "write_textgrid"]
