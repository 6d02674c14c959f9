from .pippenger import MSM, MSMConfig, default_window_bits
from .precompute import precompute_points, shift_bits_for, split_scalars

__all__ = [
    "MSM",
    "MSMConfig",
    "default_window_bits",
    "precompute_points",
    "shift_bits_for",
    "split_scalars",
]
