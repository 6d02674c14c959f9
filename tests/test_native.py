"""Native (C++/ctypes) marshalling layer vs numpy fallback."""
import numpy as np

from blaze_tpu.native import (
    bank_merge,
    bank_split,
    bytes_to_limbs,
    have_native,
    limbs_to_bytes,
    transpose,
)
from blaze_tpu.native import codec as codec_mod


def test_limb_roundtrip_both_paths():
    data = bytes(range(256)) * 3  # 24 elements of 32 B
    native = bytes_to_limbs(data, 32)
    # force the numpy fallback and compare
    saved = codec_mod._LIB
    codec_mod._LIB = False
    try:
        fallback = bytes_to_limbs(data, 32)
        assert (native == fallback).all()
        assert limbs_to_bytes(fallback, 32) == data
    finally:
        codec_mod._LIB = saved
    assert limbs_to_bytes(native, 32) == data


def test_bank_roundtrip_both_paths():
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, size=16 * 8 * 32, dtype=np.uint8).tobytes()
    banks = bank_split(data, 32, 16)
    assert len(banks) == 16
    assert bank_merge(banks, 32) == data
    saved = codec_mod._LIB
    codec_mod._LIB = False
    try:
        assert bank_split(data, 32, 16) == banks
        assert bank_merge(banks, 32) == data
    finally:
        codec_mod._LIB = saved


def test_transpose_roundtrip():
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, size=8 * 16 * 32, dtype=np.uint8).tobytes()
    t = transpose(data, 8, 16, 32)
    assert transpose(t, 16, 8, 32) == data
    saved = codec_mod._LIB
    codec_mod._LIB = False
    try:
        assert transpose(data, 8, 16, 32) == t
    finally:
        codec_mod._LIB = saved


def test_codec_against_independent_goldens():
    """Every marshalling layout vs committed fixtures from the stdlib-only
    generator (scripts/gen_codec_goldens.py) — the reference's golden
    bank-file test mode (ntt_data.rs:159-232).  Both the native C++ path
    and the numpy fallback must reproduce the independent bytes (a shared
    misunderstanding between the two in-repo paths can't pass here)."""
    import os

    fixdir = os.path.join(os.path.dirname(__file__), "fixtures")
    blobs = {}
    for name in ("input", "banks", "transposed"):
        with open(os.path.join(fixdir, f"codec_{name}.bin"), "rb") as f:
            blobs[name] = f.read()
    data = blobs["input"]
    nelems, elem, nbanks = 1024, 32, 16
    L = elem // 2

    for use_native in (True, False):
        saved = codec_mod._LIB
        if not use_native:
            codec_mod._LIB = False
        try:
            if use_native and not have_native():
                continue
            banks = bank_split(data, elem, nbanks)
            assert b"".join(banks) == blobs["banks"], f"native={use_native}"
            assert bank_merge(banks, elem) == data

            t = transpose(data, 16, 64, elem)
            assert t == blobs["transposed"], f"native={use_native}"

            limbs = bytes_to_limbs(data, elem)
            # limb l of element i == LE u16 at byte offset i*elem + 2l
            want = np.frombuffer(data, dtype="<u2").reshape(nelems, L)
            assert np.array_equal(limbs, want.astype(np.uint32))
            assert limbs_to_bytes(limbs, elem) == data
        finally:
            codec_mod._LIB = saved
