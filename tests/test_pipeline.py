"""Single-device ProofPipeline.run_batches on the flat NTT plan."""
import jax
import jax.numpy as jnp
import numpy as np

from blaze_tpu.curves import CURVES, Curve
from blaze_tpu.fields import Field
from blaze_tpu.oracle import tiled_msm_instance
from blaze_tpu.pipeline import ProofPipeline, geometric_msm_oracle


def test_run_batches_matches_geometric_oracle():
    """Delta coefficients -> the spectrum is w^i -> the MSM over points
    tiled with period 8 equals the closed-form geometric oracle, for every
    batch of the 2-deep pipeline."""
    spec = CURVES["bn254"]
    curve = Curve(spec)
    ntt_logn, msm_logn, ncls = 5, 4, 8
    m = 1 << msm_logn
    upts, _, _, dbg = tiled_msm_instance(spec, ncls, seed=91)
    pts = curve.fq.to_mont(jnp.asarray(upts[np.arange(m) % ncls]))
    ints = [0] * (1 << ntt_logn)
    ints[1] = 1
    coeffs = Field(spec.fr).from_int(ints)           # Montgomery delta

    pipe = ProofPipeline(curve, ntt_logn, msm_logn)
    outs = list(pipe.run_batches((coeffs for _ in range(3)), pts,
                                 window_bits=4))
    want = geometric_msm_oracle(spec, ncls, m,
                                spec.fr.root_of_unity(ntt_logn),
                                dbg["points"])
    assert len(outs) == 3
    for out in outs:
        aff = curve.to_affine(jax.block_until_ready(out)[None])[0]
        assert (curve.fq.to_int(aff[0]), curve.fq.to_int(aff[1])) == want
