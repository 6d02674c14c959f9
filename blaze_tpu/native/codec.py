"""ctypes binding for the native marshalling library (csrc/codec.cpp),
with numpy fallbacks when the .so hasn't been built.

Build: `make -C csrc` (drops libblaze_codec.so next to this file).
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    path = os.path.join(os.path.dirname(__file__), "libblaze_codec.so")
    if not os.path.exists(path):
        _LIB = False
        return False
    lib = ctypes.CDLL(path)
    for name, argtypes in [
        ("blz_bytes_to_limbs", [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_size_t, ctypes.c_int]),
        ("blz_limbs_to_bytes", [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_size_t, ctypes.c_int]),
        ("blz_bank_split", [ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_size_t, ctypes.c_int, ctypes.c_int]),
        ("blz_bank_merge", [ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_size_t, ctypes.c_int, ctypes.c_int]),
        ("blz_transpose", [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                           ctypes.c_size_t, ctypes.c_int]),
    ]:
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    _LIB = lib
    return lib


def have_native() -> bool:
    return bool(_load())


def bytes_to_limbs(data: bytes, nbytes: int) -> np.ndarray:
    """LE element bytes -> uint32[n, nbytes//2] limb array."""
    n = len(data) // nbytes
    lib = _load()
    if lib:
        src = np.frombuffer(data, dtype=np.uint8)
        dst = np.empty((n, nbytes // 2), dtype=np.uint32)
        lib.blz_bytes_to_limbs(
            src.ctypes.data, dst.ctypes.data, n, nbytes
        )
        return dst
    u16 = np.frombuffer(data, dtype="<u2").reshape(n, nbytes // 2)
    return u16.astype(np.uint32)


def limbs_to_bytes(limbs: np.ndarray, nbytes: int) -> bytes:
    arr = np.ascontiguousarray(limbs, dtype=np.uint32).reshape(-1, nbytes // 2)
    n = arr.shape[0]
    lib = _load()
    if lib:
        dst = np.empty(n * nbytes, dtype=np.uint8)
        lib.blz_limbs_to_bytes(arr.ctypes.data, dst.ctypes.data, n, nbytes)
        return dst.tobytes()
    return arr.astype("<u2").tobytes()


def bank_split(data: bytes, elem_bytes: int, nbanks: int = 16) -> list[bytes]:
    """Strided bank layout (the reference's 16-HBM-bank preprocess analog)."""
    n = len(data) // elem_bytes
    if n % nbanks:
        raise ValueError(f"{n} elements not divisible by {nbanks} banks")
    lib = _load()
    if lib:
        src = np.frombuffer(data, dtype=np.uint8)
        dst = np.empty(len(data), dtype=np.uint8)
        lib.blz_bank_split(src.ctypes.data, dst.ctypes.data, n, elem_bytes, nbanks)
        per = (n // nbanks) * elem_bytes
        raw = dst.tobytes()
        return [raw[i * per : (i + 1) * per] for i in range(nbanks)]
    arr = np.frombuffer(data, dtype=np.uint8).reshape(n, elem_bytes)
    return [arr[b::nbanks].tobytes() for b in range(nbanks)]


def bank_merge(banks: list[bytes], elem_bytes: int) -> bytes:
    nbanks = len(banks)
    per_bank = len(banks[0]) // elem_bytes
    n = per_bank * nbanks
    lib = _load()
    if lib:
        src = np.frombuffer(b"".join(banks), dtype=np.uint8)
        dst = np.empty(n * elem_bytes, dtype=np.uint8)
        lib.blz_bank_merge(src.ctypes.data, dst.ctypes.data, n, elem_bytes, nbanks)
        return dst.tobytes()
    out = np.empty((n, elem_bytes), dtype=np.uint8)
    for b, raw in enumerate(banks):
        out[b::nbanks] = np.frombuffer(raw, dtype=np.uint8).reshape(
            per_bank, elem_bytes
        )
    return out.tobytes()


def transpose(data: bytes, rows: int, cols: int, elem_bytes: int) -> bytes:
    lib = _load()
    if lib:
        src = np.frombuffer(data, dtype=np.uint8)
        dst = np.empty(len(data), dtype=np.uint8)
        lib.blz_transpose(src.ctypes.data, dst.ctypes.data, rows, cols, elem_bytes)
        return dst.tobytes()
    arr = np.frombuffer(data, dtype=np.uint8).reshape(rows, cols, elem_bytes)
    return np.ascontiguousarray(arr.transpose(1, 0, 2)).tobytes()
