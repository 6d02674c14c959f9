#!/usr/bin/env python3
"""Standalone marshalling-codec golden generator — INDEPENDENT of blaze_tpu.

The reference's only hardware-free unit tests check its 16-bank shuffle
against committed golden bank files
(/root/reference/src/ingo_ntt/ntt_data.rs:159-232: `inbank{00..15}.dat`
fixtures produced outside the code under test).  This generator plays that
role for the repo's marshalling layer (csrc/codec.cpp via
blaze_tpu/native/codec.py): pure python stdlib, no numpy, each layout
computed by explicit index loops so a shared misunderstanding between the
C++ codec and its numpy fallback cannot leak into the fixtures.

Layouts covered (element = 32 B little-endian, as ntt_data.rs:66):
  * limbs   — LE bytes -> u16 limb stream (fields/codec wire contract)
  * banks   — element i -> bank i % 16, order preserved per bank
              (the hbm_addrs strided scatter, ntt_data.rs:9-31,80-111)
  * transpose — (rows, cols) element matrix -> (cols, rows)

Usage: python scripts/gen_codec_goldens.py
Writes tests/fixtures/codec_*.bin.
"""
import os
import random

ELEM = 32          # bytes per element
NBANKS = 16
NELEMS = 1024      # input elements
ROWS, COLS = 16, 64


def main():
    rng = random.Random(0xC0DEC)
    data = bytes(rng.randrange(256) for _ in range(NELEMS * ELEM))

    def elem(i: int) -> bytes:
        return data[i * ELEM : (i + 1) * ELEM]

    # banks: bank b holds elements b, b+16, b+32, ... in order
    banks = b"".join(
        b"".join(elem(i) for i in range(b, NELEMS, NBANKS))
        for b in range(NBANKS)
    )

    # transpose: out element (c, r) = in element (r, c)
    assert ROWS * COLS == NELEMS
    transposed = b"".join(
        elem(r * COLS + c) for c in range(COLS) for r in range(ROWS)
    )

    fixdir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tests", "fixtures",
    )
    os.makedirs(fixdir, exist_ok=True)
    for name, blob in [
        ("codec_input.bin", data),
        ("codec_banks.bin", banks),
        ("codec_transposed.bin", transposed),
    ]:
        with open(os.path.join(fixdir, name), "wb") as f:
            f.write(blob)
        print(f"wrote tests/fixtures/{name} ({len(blob)} B)")


if __name__ == "__main__":
    main()
