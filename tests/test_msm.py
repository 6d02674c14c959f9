"""Pippenger MSM vs the python oracle (the reference's integration-test
role, cf. /root/reference/tests/integration_msm.rs)."""
import numpy as np
import pytest

import jax.numpy as jnp

from blaze_tpu.curves import CURVES, Curve
from blaze_tpu.msm import MSM, MSMConfig
from blaze_tpu.oracle import ECOracle, random_msm_instance, tiled_msm_instance


def run_msm(curve_name, n, seed, window_bits=None, tiled=False, config=None):
    spec = CURVES[curve_name]
    curve = Curve(spec)
    gen = tiled_msm_instance if tiled else random_msm_instance
    points, scalars, expected, _ = gen(spec, n, seed)
    # canonical -> Montgomery on device
    pts = curve.fq.to_mont(jnp.asarray(points))
    msm = MSM(curve, config or MSMConfig())
    result = msm(pts, jnp.asarray(scalars), window_bits=window_bits)
    got_aff = curve.to_affine(result[None])[0]
    if np.asarray(curve.is_identity(result[None]))[0]:
        got = None
    else:
        got = (curve.fq.to_int(got_aff[0]), curve.fq.to_int(got_aff[1]))
    assert np.asarray(curve.on_curve(result[None]))[0]
    assert got == expected, f"{curve_name} n={n}"


def test_msm_bn254_small():
    # minimum end-to-end slice: BN254 2^10 (BASELINE.json config 1)
    run_msm("bn254", 1 << 10, seed=1, window_bits=8)


def test_msm_bn254_tiny_edge():
    run_msm("bn254", 3, seed=2, window_bits=4)


def test_msm_bls12_381():
    run_msm("bls12_381", 257, seed=3, window_bits=8)


@pytest.mark.slow
def test_msm_bls12_377():
    run_msm("bls12_377", 64, seed=4, window_bits=8)


@pytest.mark.slow
def test_msm_tiled_large():
    # the reference's tiled-generation trick for big-N oracle checks
    run_msm("bn254", 1 << 12, seed=5, window_bits=8, tiled=True)


@pytest.mark.slow
def test_msm_chunked():
    # force multiple chunks through the accumulation path
    run_msm(
        "bn254",
        1 << 10,
        seed=6,
        window_bits=8,
        tiled=True,
        config=MSMConfig(chunk_log2=8),
    )


def test_msm_zero_and_dup_scalars():
    spec = CURVES["bn254"]
    curve = Curve(spec)
    oracle = ECOracle(spec)
    import random

    rng = random.Random(7)
    pts = [oracle.random_point(rng) for _ in range(8)]
    pts[3] = pts[2]                      # duplicate point
    scalars = [0, 1, 2, spec.fr.p - 1, 7, 7, 0, 12345]
    expected = oracle.msm(pts, scalars)

    from blaze_tpu.fields.spec import int_to_limbs

    parr = np.stack(
        [
            np.stack([int_to_limbs(x, spec.fq.nlimbs), int_to_limbs(y, spec.fq.nlimbs)])
            for x, y in pts
        ]
    )
    sarr = np.stack([int_to_limbs(s, spec.fr.nlimbs) for s in scalars])
    msm = MSM(curve)
    res = msm(curve.fq.to_mont(jnp.asarray(parr)), jnp.asarray(sarr), window_bits=4)
    aff = curve.to_affine(res[None])[0]
    got = (curve.fq.to_int(aff[0]), curve.fq.to_int(aff[1]))
    assert got == expected


@pytest.mark.parametrize("curve_name", ["bn254", "bls12_377", "bls12_381"])
def test_msm_client_random_distinct_scalars(curve_name):
    """MSMClient on wire bytes with DISTINCT random scalars over points
    tiled with period 16, vs the coefficient-sum oracle (no closed form)."""
    from blaze_tpu.curves import encode_affine_points, encode_scalars
    from blaze_tpu.oracle import class_msm_oracle, random_scalar_limbs
    from blaze_tpu.runtime import MSMClient, MSMInit, MSMInput, MSMParams
    from chip_smoke import _affine_of

    spec = CURVES[curve_name]
    n, ncls = 64, 16
    upts, _, _, dbg = tiled_msm_instance(spec, ncls, seed=81)
    scalars = random_scalar_limbs(spec, n, seed=82)
    client = MSMClient(MSMInit(curve=curve_name))
    client.initialize(MSMParams(nof_elements=n))
    client.set_data(MSMInput(
        scalars=encode_scalars(scalars, spec),
        points=encode_affine_points(upts[np.arange(n) % ncls], spec),
    ))
    client.start_process()
    res = client.result()
    assert _affine_of(res.result, spec) == class_msm_oracle(
        spec, dbg["points"], scalars)
