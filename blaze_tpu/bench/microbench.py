"""Montgomery-mul rate of one field on the device.

Times a jitted batched `Field.mul` (16-bit limbs in uint32 lanes, XLA
fused) and reports muls/s.

Usage: python -m blaze_tpu.bench.microbench [field] [log2 batch]
"""
from __future__ import annotations

import sys

import jax
import numpy as np

from ..fields import FIELDS, Field


def main():
    name = sys.argv[1] if len(sys.argv) > 1 else "bls12_381_fq"
    logb = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    n = 1 << logb
    spec = FIELDS[name]
    F = Field(spec)
    rng = np.random.default_rng(0)
    xs = [int(rng.integers(0, 2**63)) * int(rng.integers(0, 2**63)) % spec.p
          for _ in range(256)]
    uniq = F.from_int(xs)                       # (256, L) Montgomery
    a = uniq[np.arange(n) % 256]
    b = uniq[(np.arange(n) * 7 + 3) % 256]

    from .profile import bench_kernel

    mul = jax.jit(F.mul)
    stats = bench_kernel(mul, (a, b), name=f"mont_mul[{name}]", reps=10)
    t = stats.best_s
    print(stats.summary())
    dev = jax.devices()[0]
    print(f"mont_mul {name} batch 2^{logb} on {dev.device_kind}: "
          f"{t*1e3:8.3f} ms  {n/t/1e6:8.2f} Mmul/s")

    # correctness spot check
    got = F.to_int(mul(a, b))[:4]
    want = [(F.to_int(a[i:i+1])[0] * F.to_int(b[i:i+1])[0]) % spec.p
            for i in range(4)]
    assert got == want, "mont_mul mismatch"


if __name__ == "__main__":
    main()
