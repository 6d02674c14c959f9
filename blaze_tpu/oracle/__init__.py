from .ec import ECOracle
from .gen import (
    class_coefficients,
    class_msm_oracle,
    random_msm_instance,
    random_scalar_limbs,
    tiled_msm_instance,
)

__all__ = [
    "ECOracle",
    "class_coefficients",
    "class_msm_oracle",
    "random_msm_instance",
    "random_scalar_limbs",
    "tiled_msm_instance",
]
