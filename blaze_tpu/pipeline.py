"""Proof-generation pipeline: NTT -> MSM, double-buffered across primitives.

BASELINE config 5 ("NTT 2^27 + MSM 2^24 proof-gen pipeline"): the flow a
proving system runs — polynomial evaluation by NTT, then a multi-scalar
multiplication whose scalars ARE the spectral data.  The reference
pipelines ONE primitive against host I/O with two HBM buffers
(`/root/reference/tests/integration_ntt.rs:103-136`); here the same
2-deep software pipeline runs ACROSS primitives: while the MSM of batch k
executes, the NTT of batch k+1 is already dispatched (JAX async dispatch
is the task queue, msm_hw_code.rs:19-25 analog).

Single device: the flat (n, L) NTT plan feeding the (N, 2, L) Pippenger
MSM.  Distributed: DistributedNTT (all_to_all stage exchange) feeding
DistributedMSM (dp-sharded scan + all_gather reduce) over one mesh.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .curves.ops import Curve
from .fields.mont import Field
from .fields.spec import FieldSpec
from .msm import MSM, MSMConfig
from .ntt import make_ntt

__all__ = ["ProofPipeline", "geometric_msm_oracle"]


class ProofPipeline:
    """NTT(coeffs) -> scalars -> MSM(points, scalars) for one curve.

    curve.fr is the NTT field.  `msm_logn` <= `ntt_logn`: the first
    2^msm_logn spectral values become the MSM scalars (a proving system
    commits to evaluation-form polynomials; the slice keeps shapes
    static).
    """

    def __init__(self, curve: Curve, ntt_logn: int, msm_logn: int,
                 mesh=None, msm_axis: str = "dp", ntt_axis: str = "sp",
                 config: MSMConfig | None = None):
        self.curve = curve
        self.fr: FieldSpec = curve.spec.fr
        self.ntt_logn = ntt_logn
        self.msm_logn = msm_logn
        if msm_logn > ntt_logn:
            raise ValueError("msm_logn must be <= ntt_logn")
        self.mesh = mesh
        if mesh is not None:
            from .dist import DistributedMSM, DistributedNTT

            self.dntt = DistributedNTT(self.fr, ntt_logn, mesh, axis=ntt_axis)
            self.dmsm = DistributedMSM(curve, mesh, axis=msm_axis,
                                       config=config)
            self.plan = None
            self.msm = None
        else:
            self.plan = make_ntt(self.fr, ntt_logn)
            self.msm = MSM(curve, config)
            self.dntt = self.dmsm = None

    # ----------------------------------------------------- single device
    @functools.cached_property
    def _scalars_of(self):
        """Jitted spectral (2^n, L) Montgomery -> canonical (2^m, L) MSM
        scalars: the first 2^msm_logn values, out of Montgomery form."""
        f = Field(self.fr)
        m = 1 << self.msm_logn
        return jax.jit(lambda y: f.from_mont(y[:m]))

    def run_batches(self, coeff_batches, points_mont,
                    window_bits: int | None = None):
        """The 2-deep cross-primitive pipeline (single-device path).

        coeff_batches: iterable of (2^n, L) uint32 Montgomery coefficient
        buffers.  points_mont: (2^m, 2, L) affine Montgomery bases.
        Yields one (3, L) projective MSM result per batch; batch k+1's
        NTT is dispatched before batch k's MSM is waited on.
        """
        if self.plan is None:
            raise ValueError("mesh pipeline uses run_dist")
        pending = []                      # MSM results in flight
        for x in coeff_batches:
            y = self.plan.ntt(jnp.asarray(x))               # dispatch NTT k
            scal = self._scalars_of(y)
            # drop the spectral buffer's ref now: the scalar slice is its
            # own (smaller) buffer, and holding y through the MSM dispatch
            # raises the 2-deep peak by one full NTT buffer
            del y
            res = self.msm(points_mont, scal,
                           window_bits=window_bits)         # dispatch MSM k
            pending.append(res)
            # 2-deep: wait for the OLDEST once two are in flight — batch
            # k+1's dispatches happened before this barrier
            if len(pending) > 1:
                out = pending.pop(0)
                jax.block_until_ready(out)
                yield out
        for out in pending:
            jax.block_until_ready(out)
            yield out

    # -------------------------------------------------------- distributed
    def run_dist(self, coeffs, points_mont, window_bits: int | None = None,
                 scalar_bits: int | None = None, scalar_mask=None):
        """Mesh path: sharded NTT (all_to_all stages) feeding the
        dp-sharded MSM.  coeffs: (2^n, L) u32 Montgomery; points_mont:
        (2^m, 2, L) u32 affine Montgomery.  scalar_mask optionally
        truncates spectral scalars (compile-light dry runs)."""
        if self.dntt is None:
            raise ValueError("no mesh — use run_batches")
        yk = self.dntt.ntt(coeffs)                      # (n1, n2, L) k-matrix
        ynat = self.dntt.spectral_to_natural(yk)        # (2^n, L)
        scalars = jnp.asarray(ynat[: 1 << self.msm_logn])
        # spectral values are Montgomery-form; scalars must be canonical
        scalars = Field(self.fr).jit_op("from_mont")(scalars)
        if scalar_mask is not None:
            # per-limb bit mask (e.g. [0xFF, 0, ...] keeps 8 live scalar
            # bits): lets compile-light dry runs keep the full composition
            scalars = scalars & jnp.asarray(scalar_mask, scalars.dtype)
        return self.dmsm(points_mont, scalars, window_bits=window_bits,
                         scalar_bits=scalar_bits)


def geometric_msm_oracle(curve_spec, npoints_unique: int, n: int, w: int,
                         base_points):
    """Expected MSM for scalars s_i = w^i over period-tiled points.

    With points tiled with period U (the reference's own large-size test
    trick, tests/msm/mod.rs:23-31), class j holds the M_j = ceil((n-j)/U)
    indices j, j+U, ..., so its coefficient is the closed-form geometric
    sum
        c_j = w^j * ((w^(U*M_j) - 1) / (w^U - 1))
    and a 2^24-scale pipeline result is oracle-checkable with a U-point
    host MSM.  Needs w^U != 1.  When n is the NTT size and U divides it,
    every c_j is 0 (a full sum of roots of unity): take n shorter than
    the NTT, or a U that does not divide n.  Returns the affine point.
    """
    from .oracle import ECOracle

    p = curve_spec.fr.p
    U = npoints_unique
    den_inv = pow((pow(w, U, p) - 1) % p, -1, p)
    coeffs = []
    for j in range(U):
        m_j = -(-(n - j) // U)
        coeffs.append(pow(w, j, p) * (pow(w, U * m_j, p) - 1) * den_inv % p)
    return ECOracle(curve_spec).msm(base_points, coeffs)
