"""Dynamic programmes and lattice ops: MAS, forward-sum, prior, MoBo, the
mel front end, durations and regularizers."""
from .forward_sum import (alignment_posteriors, forward_sum_loss,
                          forward_sum_loss_with_posteriors)
from .mas import mas_path_frame_major, maximum_path
from .mas_kernel import mas_backtrack, mas_bits
from .mas_reference import mas_single, maximum_path_numpy
from .mel import MelConfig, log_mel_spectrogram, mel_filterbank, spectrogram
from .mobo import mobo_forward, mobo_hard_boundaries, mobo_loss
from .prior import beta_binomial_log_prior
from .regularizers import attention_centroids, monotonic_attention_loss

__all__ = [
    "MelConfig",
    "alignment_posteriors",
    "attention_centroids",
    "beta_binomial_log_prior",
    "forward_sum_loss",
    "forward_sum_loss_with_posteriors",
    "log_mel_spectrogram",
    "mas_backtrack",
    "mas_bits",
    "mas_path_frame_major",
    "mas_single",
    "maximum_path",
    "maximum_path_numpy",
    "mel_filterbank",
    "mobo_forward",
    "mobo_hard_boundaries",
    "mobo_loss",
    "monotonic_attention_loss",
    "spectrogram",
]
