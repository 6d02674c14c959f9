"""MSM test-instance generators, including the reference's tiling trick.

The reference keeps large-size oracle computation cheap by generating only
LARGE_PARAM=256 unique (point, scalar) pairs and tiling them
(`/root/reference/tests/msm/mod.rs:23-31`, tiling at 92-109), so the expected
result is `(N / 256) * msm(unique) + partial`.  Same trick here.
"""
from __future__ import annotations

import random

import numpy as np

from ..curves.spec import CurveSpec
from ..fields.spec import int_to_limbs
from .ec import ECOracle

LARGE_PARAM = 256  # tests/msm/mod.rs:23 `get_large_param` cap


def _points_to_affine_limbs(spec: CurveSpec, points) -> np.ndarray:
    L = spec.fq.nlimbs
    out = np.zeros((len(points), 2, L), dtype=np.uint32)
    for i, (x, y) in enumerate(points):
        out[i, 0] = int_to_limbs(x, L)
        out[i, 1] = int_to_limbs(y, L)
    return out


def _scalars_to_limbs(spec: CurveSpec, scalars) -> np.ndarray:
    L = spec.fr.nlimbs
    out = np.zeros((len(scalars), L), dtype=np.uint32)
    for i, s in enumerate(scalars):
        out[i] = int_to_limbs(s, L)
    return out


def random_msm_instance(spec: CurveSpec, n: int, seed: int = 0):
    """n unique pairs + expected result. O(n) oracle cost — keep n small."""
    rng = random.Random(seed)
    oracle = ECOracle(spec)
    points = [oracle.random_point(rng) for _ in range(n)]
    scalars = [rng.randrange(spec.fr.p) for _ in range(n)]
    expected = oracle.msm(points, scalars)
    return (
        _points_to_affine_limbs(spec, points),
        _scalars_to_limbs(spec, scalars),
        expected,
        {"points": points, "scalars": scalars},
    )


def tiled_msm_instance(spec: CurveSpec, n: int, seed: int = 0):
    """n pairs built by tiling <=256 unique ones; cheap exact expected value."""
    uniq = min(n, LARGE_PARAM)
    rng = random.Random(seed)
    oracle = ECOracle(spec)
    upoints = [oracle.random_point(rng) for _ in range(uniq)]
    uscalars = [rng.randrange(spec.fr.p) for _ in range(uniq)]

    reps, rem = divmod(n, uniq)
    # expected = reps * msm(all uniq) + msm(first rem uniq)
    full = oracle.msm(upoints, uscalars)
    expected = None
    for _ in range(reps):
        expected = oracle.add(expected, full)
    if rem:
        expected = oracle.add(expected, oracle.msm(upoints[:rem], uscalars[:rem]))

    up = _points_to_affine_limbs(spec, upoints)
    us = _scalars_to_limbs(spec, uscalars)
    idx = np.arange(n) % uniq
    return up[idx], us[idx], expected, {"points": upoints, "scalars": uscalars}


def random_scalar_limbs(spec: CurveSpec, n: int, seed: int = 0) -> np.ndarray:
    """(n, Ls) uint32 limbs of n DISTINCT random scalars below r.

    Made in bulk with numpy: every limb uniform, the top limb cut to
    fr.bits - 1 bits so each value is < 2^(fr.bits-1) < r.  Distinctness
    is checked on the low 64 bits (distinct there implies distinct)."""
    fr = spec.fr
    rng = np.random.default_rng(seed)
    out = rng.integers(0, 1 << 16, size=(n, fr.nlimbs), dtype=np.uint32)
    top_bits = fr.bits - 1 - 16 * (fr.nlimbs - 1)
    out[:, -1] &= (1 << top_bits) - 1
    low = np.zeros(n, np.uint64)
    for i in range(4):
        low |= out[:, i].astype(np.uint64) << np.uint64(16 * i)
    if np.unique(low).size != n:
        raise ValueError(f"seed {seed} gives repeated scalars; pick another")
    return out


def class_coefficients(spec: CurveSpec, scalars: np.ndarray,
                       nclasses: int = LARGE_PARAM) -> list[int]:
    """Per-class scalar sums mod r for points tiled with period `nclasses`
    (point i is class i % nclasses): the MSM then equals
    sum_j coeff_j * P_j over the unique points.  Column sums of 16-bit
    limbs stay exact in int64 for up to 2^47 points per class."""
    s = np.asarray(scalars, dtype=np.int64)
    n, nl = s.shape
    pad = -n % nclasses
    if pad:
        s = np.concatenate([s, np.zeros((pad, nl), np.int64)])
    cols = s.reshape(-1, nclasses, nl).sum(axis=0)       # (nclasses, Ls)
    r = spec.fr.p
    return [
        sum(int(v) << (16 * i) for i, v in enumerate(row)) % r for row in cols
    ]


def class_msm_oracle(spec: CurveSpec, class_points, scalars: np.ndarray):
    """Expected affine MSM of scalars over points tiled with period
    len(class_points): the coefficient-sum MSM over the point classes,
    with direct sums and no closed form.  The sums are reduced mod r, so
    the points must lie in the r-order subgroup (`ECOracle.random_point`
    samples there)."""
    coeffs = class_coefficients(spec, scalars, len(class_points))
    return ECOracle(spec).msm(class_points, coeffs)
