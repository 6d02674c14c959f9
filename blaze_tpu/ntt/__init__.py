from .transform import NTTPlan, FourStepNTT, make_ntt

__all__ = [
    "NTTPlan",
    "FourStepNTT",
    "make_ntt",
]
