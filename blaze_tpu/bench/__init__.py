from .profile import (
    KernelStats,
    SOL_TABLE,
    bench_kernel,
    scaling_efficiency,
    speed_of_light,
)

__all__ = [
    "KernelStats",
    "SOL_TABLE",
    "bench_kernel",
    "scaling_efficiency",
    "speed_of_light",
]
