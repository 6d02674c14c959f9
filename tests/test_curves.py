"""Curve group-law tests vs the python oracle (all three curves).

All device calls go through cached jitted ops with a single batch shape
(BATCH=8) per curve so each op compiles exactly once per process (and hits
the persistent XLA cache across processes).
"""
import random

import numpy as np
import pytest

import jax.numpy as jnp

from blaze_tpu.curves import CURVES, Curve
from blaze_tpu.oracle import ECOracle

BATCH = 8


@pytest.fixture(params=sorted(CURVES), ids=sorted(CURVES), scope="module")
def env(request):
    spec = CURVES[request.param]
    return Curve(spec), ECOracle(spec)


def to_proj(curve: Curve, pts):
    """list of BATCH oracle points (or None) -> device projective, Montgomery."""
    assert len(pts) == BATCH
    f = curve.fq
    xs = [0 if p is None else p[0] for p in pts]
    ys = [1 if p is None else p[1] for p in pts]
    zs = [0 if p is None else 1 for p in pts]
    return curve.pack(f.from_int(xs), f.from_int(ys), f.from_int(zs))


def to_affine_dev(curve: Curve, pts):
    """list of BATCH oracle points (no None) -> device affine (B,2,L) mont."""
    f = curve.fq
    return jnp.stack(
        [f.from_int([p[0] for p in pts]), f.from_int([p[1] for p in pts])],
        axis=-2,
    )


def to_oracle_affine(curve: Curve, p):
    """device projective batch -> list of oracle points."""
    aff = curve.jit_op("to_affine")(p)
    xs = curve.fq.to_int(aff[..., 0, :])
    ys = curve.fq.to_int(aff[..., 1, :])
    ident = np.asarray(curve.jit_op("is_identity")(p))
    return [
        None if isid else (x, y) for x, y, isid in zip(xs, ys, ident)
    ]


def rand_points(oracle, n, rng):
    return [oracle.random_point(rng) for _ in range(n)]


def test_generator_on_curve(env):
    curve, oracle = env
    assert oracle.on_curve(oracle.generator), curve.spec.name


def test_add_matches_oracle(env):
    curve, oracle = env
    rng = random.Random(10)
    ps = rand_points(oracle, BATCH, rng)
    qs = rand_points(oracle, BATCH, rng)
    # adversarial cases: P + P, P + (-P), P + 0, 0 + P, 0 + 0
    ps[0], qs[0] = ps[1], ps[1]
    qs[1] = oracle.neg(ps[1])
    qs[2] = None
    ps[3] = None
    ps[4], qs[4] = None, None
    got = curve.jit_op("add")(to_proj(curve, ps), to_proj(curve, qs))
    assert np.asarray(curve.jit_op("on_curve")(got)).all()
    want = [oracle.add(p, q) for p, q in zip(ps, qs)]
    assert to_oracle_affine(curve, got) == want


def test_dbl_matches_oracle(env):
    curve, oracle = env
    rng = random.Random(11)
    ps = rand_points(oracle, BATCH, rng)
    ps[0] = None  # double of identity
    got = curve.jit_op("dbl")(to_proj(curve, ps))
    want = [oracle.dbl(p) for p in ps]
    assert to_oracle_affine(curve, got) == want


def test_add_mixed_matches_oracle(env):
    curve, oracle = env
    rng = random.Random(12)
    ps = rand_points(oracle, BATCH, rng)
    qs = rand_points(oracle, BATCH, rng)
    ps[0] = qs[0]                 # doubling through mixed add
    ps[1] = oracle.neg(qs[1])     # cancellation to identity
    ps[2] = None                  # identity + affine
    got = curve.jit_op("add_mixed")(to_proj(curve, ps), to_affine_dev(curve, qs))
    want = [oracle.add(p, q) for p, q in zip(ps, qs)]
    assert to_oracle_affine(curve, got) == want


def test_neg_gives_identity(env):
    curve, oracle = env
    rng = random.Random(13)
    ps = rand_points(oracle, BATCH, rng)
    dev = to_proj(curve, ps)
    s = curve.jit_op("add")(dev, curve.jit_op("neg")(dev))
    assert np.asarray(curve.jit_op("is_identity")(s)).all()


def test_scalar_mul(env):
    curve, oracle = env
    rng = random.Random(14)
    # one batched scalar_mul call: same k applied to BATCH points
    ps = rand_points(oracle, BATCH, rng)
    k = 0xDEADBEEF
    got = curve.scalar_mul(to_proj(curve, ps), k)
    want = [oracle.mul(p, k) for p in ps]
    assert to_oracle_affine(curve, got) == want


def test_on_curve_rejects(env):
    curve, oracle = env
    rng = random.Random(15)
    ps = rand_points(oracle, BATCH, rng)
    bad = (ps[1][0], (ps[1][1] + 1) % oracle.p)
    ps[1] = bad
    oc = np.asarray(curve.jit_op("on_curve")(to_proj(curve, ps)))
    assert oc[0] and not oc[1] and oc[2:].all()


def test_codec_roundtrip(env):
    curve, oracle = env
    from blaze_tpu.curves import (
        decode_affine_points,
        encode_affine_points,
        encode_projective_result,
        decode_projective_result,
    )
    from blaze_tpu.fields.spec import int_to_limbs

    spec = curve.spec
    rng = random.Random(16)
    pts = rand_points(oracle, 4, rng)
    arr = np.stack(
        [
            np.stack(
                [int_to_limbs(x, spec.fq.nlimbs), int_to_limbs(y, spec.fq.nlimbs)]
            )
            for x, y in pts
        ]
    )
    raw = encode_affine_points(arr, spec)
    assert len(raw) == 4 * spec.point_bytes  # 96 B (BLS) / 64 B (BN254)
    assert (decode_affine_points(raw, spec) == arr).all()

    proj = np.stack(
        [
            int_to_limbs(pts[0][0], spec.fq.nlimbs),
            int_to_limbs(pts[0][1], spec.fq.nlimbs),
            int_to_limbs(1, spec.fq.nlimbs),
        ]
    )
    res = encode_projective_result(proj, spec)
    assert len(res) == spec.result_bytes  # 144 B (BLS) / 96 B (BN254)
    assert (decode_projective_result(res, spec) == proj).all()


def test_wire_sizes_match_reference():
    # /root/reference/src/ingo_msm/msm_cfg.rs:44-92
    assert CURVES["bls12_381"].point_bytes == 96
    assert CURVES["bls12_381"].result_bytes == 144
    assert CURVES["bls12_377"].point_bytes == 96
    assert CURVES["bls12_377"].result_bytes == 144
    assert CURVES["bn254"].point_bytes == 64
    assert CURVES["bn254"].result_bytes == 96
