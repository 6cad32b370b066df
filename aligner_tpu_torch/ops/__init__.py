"""Dynamic programmes and lattice ops: MAS, forward-sum, prior, MoBo."""
from .forward_sum import forward_sum_loss, forward_sum_loss_with_posteriors
from .mas import mas_path_frame_major, maximum_path
from .mas_kernel import mas_backtrack, mas_bits
from .mas_reference import mas_single, maximum_path_numpy
from .mobo import mobo_forward, mobo_hard_boundaries, mobo_loss
from .prior import beta_binomial_log_prior

__all__ = [
    "beta_binomial_log_prior",
    "forward_sum_loss",
    "forward_sum_loss_with_posteriors",
    "mas_backtrack",
    "mas_bits",
    "mas_path_frame_major",
    "mas_single",
    "maximum_path",
    "maximum_path_numpy",
    "mobo_forward",
    "mobo_hard_boundaries",
    "mobo_loss",
]
