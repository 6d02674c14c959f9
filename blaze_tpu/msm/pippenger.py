"""Pippenger multi-scalar multiplication on plain JAX/XLA.

Replaces the reference's FPGA MSM engine (`/root/reference/src/ingo_msm/`,
register lifecycle in msm_api.rs:72-274) with an actual bucket-method
implementation designed for XLA:

  1. c-bit digit decomposition of 16-bit scalar limbs (c=16 gives digits ==
     limbs; the reference's 8x precompute over 32-bit windows,
     msm_api.rs:39-40, is the same windowing idea);
  2. per window: sort point indices by digit (XLA sort instead of a
     scatter, so bucket accumulation becomes contiguous-run reduction);
  3. an EC *prefix scan* over the sorted points, computed as a two-level
     sequential lane scan (lax.scan over N/R steps of R-wide batched
     complete additions) — work-efficient (~N adds) with a graph containing
     only O(1) group-op instances, unlike tree/associative scans;
  4. bucket sums are never materialized: by Abel summation,
         sum_j j * B_j  =  (B-1) * T[e_{B-1}]  -  sum_{j<B-1} T[e_j]
     where T is the prefix sum and e_j the last sorted index with digit <= j
     (empty buckets fall out automatically);
  5. Horner window fold with c doublings per window.

Everything is fixed-shape, branchless, and batched — the only sequential
latency is the lane-scan step counts (~sqrt chunk size).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp

from ..curves.ops import Curve
from ..fields.spec import LIMB_BITS


_REDUCE_STEPS = 16   # sequential adds per level of _tree_reduce


def _ceil_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _vary_like(x, ref):
    """Tag x as varying over ref's shard_map-manual axes (vma).

    lax.scan/fori_loop require carry init and body output to agree on
    varying axes; identity-point inits built from constants are unvarying
    while the scanned points are varying inside shard_map bodies.  No-op
    outside shard_map."""
    try:
        vma = jax.typeof(ref).vma
    except Exception:
        return x
    if not vma:
        return x
    return jax.lax.pcast(x, tuple(vma), to="varying")


@dataclasses.dataclass(frozen=True)
class MSMConfig:
    """Static planning knobs (hashable; safe as a jit static argument)."""

    window_bits: int = 16          # c; buckets per window B = 2^c
    chunk_log2: int = 20           # points per device pass (memory bound)
    scan_lanes: int = 0            # 0 = auto (~4 sqrt of padded chunk)
    group_windows: int = 6         # windows co-scanned per pass (memory bound)


def default_window_bits(n: int) -> int:
    """Pick c so bucket work (~3*2^c) stays well below scan work (~n)."""
    if n <= 0:
        return 1
    c = max(1, min(16, int(math.log2(max(n, 2))) - 3))
    return c


class MSM:
    """Pippenger MSM engine for one curve."""

    def __init__(self, curve: Curve, config: MSMConfig | None = None):
        self.curve = curve
        self.config = config or MSMConfig()

    # The jitted methods take `self` as a static argument: engines with the
    # same curve and config share their compiled programs.
    def _key(self):
        return (self.curve.spec.name, self.config)

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, MSM) and self._key() == other._key()

    # ------------------------------------------------------------ digits
    def _digits(self, scalars, c: int, nwin: int):
        """(N, Ls) 16-bit limbs -> (nwin, N) c-bit digits (uint32)."""
        Ls = scalars.shape[-1]
        padded = jnp.pad(scalars, [(0, 0)] * (scalars.ndim - 1) + [(0, 2)])
        outs = []
        mask = jnp.uint32((1 << c) - 1)
        for w in range(nwin):
            lo_bit = w * c
            limb, off = divmod(lo_bit, LIMB_BITS)
            d = padded[..., limb] >> off
            if off + c > LIMB_BITS:
                d = d | (padded[..., limb + 1] << (LIMB_BITS - off))
            if off + c > 2 * LIMB_BITS:  # c > 16 never spans 3 limbs (c<=16)
                raise ValueError("window_bits must be <= 16")
            outs.append(d & mask)
        return jnp.stack(outs, axis=0)

    # ------------------------------------------------- sequential EC scan
    def _proj_scan(self, pts):
        """Inclusive EC prefix sum over axis 0 of (M, ..., 3, L) points.

        Middle axes are batch.  Two-level lane decomposition; recursion
        keeps the graph at O(1) group-op instances per level (~3 levels
        total for M <= 2^24).
        """
        cv = self.curve
        M = pts.shape[0]
        rest = pts.shape[1:]
        ident = _vary_like(jnp.broadcast_to(cv.identity(), rest), pts)
        if M == 1:
            return pts
        if M <= 128:
            def body(carry, p):
                nxt = cv.add(carry, p)
                return nxt, nxt

            _, out = jax.lax.scan(body, ident, pts)
            return out

        R = _ceil_pow2(int(math.sqrt(M)))
        C = -(-M // R)
        pad = R * C - M
        if pad:
            pads = jnp.broadcast_to(cv.identity(), (pad, *rest))
            pts = jnp.concatenate([pts, pads], axis=0)
        grid = jnp.moveaxis(pts.reshape(R, C, *rest), 1, 0)  # (C, R, *rest)

        def body(carry, row):
            nxt = cv.add(carry, row)
            return nxt, nxt

        lane_tot, emitted = jax.lax.scan(
            body, _vary_like(jnp.broadcast_to(cv.identity(), (R, *rest)), pts),
            grid,
        )
        carries = self._proj_scan(lane_tot)  # inclusive over lanes
        excl = jnp.concatenate([ident[None], carries[:-1]], axis=0)
        fixed = cv.add(emitted, excl[None])  # (C, R, *rest)
        out = jnp.moveaxis(fixed, 0, 1).reshape(R * C, *rest)
        return out[:M]

    def _tree_reduce(self, pts):
        """EC sum over axis 0 of (M, ..., 3, L); ~M total group adds.

        Each level folds the M rows into ceil(M/_REDUCE_STEPS) lane totals
        with one lax.scan of at most _REDUCE_STEPS batched adds, then
        recurses: log_16(M) levels with one add instance each.  Compile time
        grows with the number of distinct add instances (a halving tree
        has one per level of log2 M), and the live batch stays M/steps.
        """
        cv = self.curve
        M = pts.shape[0]
        rest = pts.shape[1:]
        if M == 1:
            return pts[0]
        R = -(-M // _REDUCE_STEPS)
        C = -(-M // R)
        pad = R * C - M
        if pad:
            pads = jnp.broadcast_to(cv.identity(), (pad, *rest))
            pts = jnp.concatenate([pts, pads], axis=0)

        def body(carry, row):
            return cv.add(carry, row), None

        lane_tot, _ = jax.lax.scan(
            body, _vary_like(jnp.broadcast_to(cv.identity(), (R, *rest)), pts),
            pts.reshape(C, R, *rest),
        )
        return self._tree_reduce(lane_tot)

    # ------------------------------------------------ grouped window sums
    def _scan_phase(self, pts_affine, digits, c: int):
        """Sort + batched lane scan + boundary gather for G windows.

        pts_affine: (N, 2, L) affine Montgomery; digits: (G, N) c-bit.
        Returns (carry_g, local, bounds): the two projective halves of each
        bucket-boundary prefix value T[e_j] = carry + local, (G, B, 3, L)
        each, plus the raw (G, B) boundary indices (-1 = empty).

        All G windows ride one lax.scan: per step the mixed-add batch is
        (G, R) — G x wider batches and G x fewer sequential steps
        than scanning windows one at a time.  Scan emissions are stored as
        uint16 (limbs are < 2^16) to halve the O(N*G) device footprint.
        """
        cv = self.curve
        G, N = digits.shape
        B = 1 << c
        L = pts_affine.shape[-1]

        with jax.named_scope("msm_sort"):
            order = jnp.argsort(digits, axis=-1)                # (G, N)
            sorted_d = jnp.take_along_axis(digits, order, axis=-1)
            sorted_p = jnp.take(pts_affine, order, axis=0)      # (G, N, 2, L)

            # e_j = last sorted index with digit <= j  (=-1 if none)
            targets = jnp.arange(1, B + 1, dtype=digits.dtype)
            bounds = (
                jax.vmap(lambda d: jnp.searchsorted(d, targets))(sorted_d)
                .astype(jnp.int32)
                - 1
            )                                                   # (G, B)

        # Lane count: wider than sqrt(N) so every scan step is a large
        # batched add; the O(R) lane-carry fix-up stays a small fraction
        # of the O(N) scan.
        R = self.config.scan_lanes or _ceil_pow2(4 * int(math.sqrt(N)))
        R = min(R, N)
        C = -(-N // R)
        pad = R * C - N
        if pad:
            # affine padding: repeat the last point; pads sort past every
            # real bucket so no boundary index ever reaches them
            last = jnp.broadcast_to(sorted_p[:, -1:], (G, pad, 2, L))
            sorted_p = jnp.concatenate([sorted_p, last], axis=1)
        grid = jnp.moveaxis(sorted_p.reshape(G, R, C, 2, L), 2, 0)  # (C,G,R,2,L)

        ident = _vary_like(cv.identity(), pts_affine)

        def body(carry, row):
            nxt = cv.add_mixed(carry, row)
            return nxt, nxt.astype(jnp.uint16)

        lane_tot, emitted = jax.lax.scan(
            body, jnp.broadcast_to(ident, (G, R, 3, L)), grid
        )                                      # emitted: (C, G, R, 3, L) u16

        # lane-carry fix-up, batched over G
        lane_prefix = self._proj_scan(jnp.moveaxis(lane_tot, 1, 0))  # (R,G,3,L)
        excl = jnp.concatenate(
            [jnp.broadcast_to(ident, (1, G, 3, L)), lane_prefix[:-1]], axis=0
        )

        safe = jnp.maximum(bounds, 0)         # (G, B)
        lane_idx = safe // C
        col_idx = safe % C
        gidx = jnp.arange(G, dtype=jnp.int32)[:, None]
        local = emitted[col_idx, gidx, lane_idx].astype(jnp.uint32)  # (G,B,3,L)
        carry_g = excl[lane_idx, gidx]                               # (G,B,3,L)

        valid = bounds >= 0
        identb = jnp.broadcast_to(ident, local.shape)
        local = cv.select(valid, local, identb)
        carry_g = cv.select(valid, carry_g, identb)
        return carry_g, local, bounds

    def _bucket_phase(self, carry_g, local, c: int):
        """Abel summation over boundary prefix values -> (G, 3, L).

        sum_j j*B_j = (B-1) * T[e_{B-1}] - sum_{j<B-1} T[e_j];
        T[e_j] = carry + local, so the sum over j is one tree reduction
        over the 2(B-1) gathered halves, and (B-1)*T = 2^c*T - T is c
        doublings plus one subtract (no double-and-add select chain).
        """
        cv = self.curve
        B = 1 << c
        total = cv.add(carry_g[:, B - 1], local[:, B - 1])       # (G, 3, L)

        def dbl(_, a):
            return cv.dbl(a)

        shifted = jax.lax.fori_loop(0, c, dbl, total)            # 2^c * T
        acc = cv.add(shifted, cv.neg(total))                     # (B-1) * T
        if B > 1:
            rest = jnp.concatenate(
                [carry_g[:, : B - 1], local[:, : B - 1]], axis=1
            )                                                    # (G,2B-2,3,L)
            partial = self._tree_reduce(jnp.moveaxis(rest, 1, 0))
            acc = cv.add(acc, cv.neg(partial))
        return acc

    def _window_sums_group(self, pts_affine, digits, c: int):
        """sum_j j*B_j for G windows at once -> (G, 3, L)."""
        carry_g, local, _ = self._scan_phase(pts_affine, digits, c)
        return self._bucket_phase(carry_g, local, c)

    # ------------------------------------------------------------- driver
    def msm_chunk(self, points_aff_mont, scalars, c: int,
                  scalar_bits: int | None = None):
        """MSM over one resident chunk. Returns per-window sums (W, 3, L).

        `scalar_bits` < fr.bits is the precomputed-multiples mode: slices
        from msm/precompute.py carry only that many live bits, so fewer
        windows are scanned (msm_api.rs:39-40 parity).

        Windows run in co-scanned groups of ~group_windows; padded windows
        (digits all zero) cost nothing extra and reduce to the identity.
        """
        nwin = -(-(scalar_bits or self.curve.spec.fr.bits) // c)
        digits = self._digits(scalars, c, nwin)  # (W, N)

        ngroups = -(-nwin // max(1, self.config.group_windows))
        G = -(-nwin // ngroups)
        wpad = ngroups * G
        if wpad > nwin:
            digits = jnp.pad(digits, ((0, wpad - nwin), (0, 0)))
        dgrid = digits.reshape(ngroups, G, -1)

        def per_group(_, dg):
            return None, self._window_sums_group(points_aff_mont, dg, c)

        _, wsums = jax.lax.scan(per_group, None, dgrid)  # (ngroups, G, 3, L)
        return wsums.reshape(wpad, 3, -1)[:nwin]

    def fold_windows(self, wsums, c: int):
        """Horner fold: result = sum_w 2^(c*w) * wsums[w]."""
        cv = self.curve
        W = wsums.shape[0]

        def outer(w, acc):
            def dblc(_, a):
                return cv.dbl(a)

            acc = jax.lax.fori_loop(0, c, dblc, acc)
            return cv.add(acc, wsums[W - 2 - w])

        return jax.lax.fori_loop(0, W - 1, outer, wsums[W - 1])

    @functools.partial(jax.jit, static_argnums=(0, 3, 4))
    def _msm_jit(self, points, scalars, c: int, scalar_bits=None):
        wsums = self.msm_chunk(points, scalars, c, scalar_bits)
        return self.fold_windows(wsums, c)

    @functools.partial(jax.jit, static_argnums=(0, 2, 3))
    def _digits_jit(self, scalars, c: int, nwin: int):
        return self._digits(scalars, c, nwin)

    @functools.partial(jax.jit, static_argnums=(0, 3))
    def _scan_phase_jit(self, points, digits_g, c: int):
        return self._scan_phase(points, digits_g, c)

    @functools.partial(jax.jit, static_argnums=(0, 3))
    def _bucket_phase_jit(self, carry_g, local, c: int):
        return self._bucket_phase(carry_g, local, c)

    def _group_jit(self, points, digits_g, c: int):
        """One window group, as two separately-compiled phases (XLA:CPU
        whole-program compile scales superlinearly; splitting keeps each
        phase's compile tractable and both instances are reused across
        every group and chunk)."""
        carry_g, local, _ = self._scan_phase_jit(points, digits_g, c)
        return self._bucket_phase_jit(carry_g, local, c)

    @functools.partial(jax.jit, static_argnums=(0, 2))
    def _fold_jit(self, wsums, c: int):
        return self.fold_windows(wsums, c)

    @functools.partial(jax.jit, static_argnums=0)
    def _add_wsums(self, a, b):
        return self.curve.add(a, b)

    # ----------------------------------------- streaming partial surface
    #
    # The client's streaming set_data (the reference's 2048-element DMA
    # overlap, msm_api.rs:156-217) consumes chunks as they land on device:
    # each chunk contributes per-window partial sums, accumulated on
    # device, and the fold runs once at wait_result.  These two methods
    # are the per-chunk body of __call__, exposed so the partials can be
    # dispatched as operands arrive instead of after full staging.

    def msm_partial(self, points, scalars, c: int,
                    scalar_bits: int | None = None):
        """Per-window sums (nwin, 3, L) of one resident chunk."""
        nwin = -(-(scalar_bits or self.curve.spec.fr.bits) // c)
        ngroups = -(-nwin // max(1, self.config.group_windows))
        G = -(-nwin // ngroups)
        wpad = ngroups * G
        digits = self._digits_jit(scalars, c, nwin)
        if wpad > nwin:
            digits = jnp.pad(digits, ((0, wpad - nwin), (0, 0)))
        parts = [
            self._group_jit(points, digits[g * G : (g + 1) * G], c)
            for g in range(ngroups)
        ]
        return jnp.concatenate(parts, axis=0)[:nwin]

    def accumulate(self, wsums, part):
        """Running per-window accumulation across streamed chunks."""
        return part if wsums is None else self._add_wsums(wsums, part)

    def finalize(self, wsums, c: int):
        """Horner window fold of accumulated partials -> (3, L) mont."""
        return self._fold_jit(wsums, c)

    def __call__(self, points_aff_mont, scalars, window_bits: int | None = None,
                 scalar_bits: int | None = None):
        """MSM of (N, 2, L) Montgomery affine points with (N, Ls) canonical
        scalar limbs. Returns one projective point (3, L), Montgomery form.

        Orchestration happens in Python: one compiled window-group kernel
        is re-dispatched per (chunk, group) — JAX async dispatch queues the
        launches back-to-back (the task-queue behavior the reference gets
        from its FPGA queue, msm_hw_code.rs:19-25) while compile cost stays
        one kernel instead of a mega-graph.  Large inputs stream in chunks
        of 2^chunk_log2 points (the reference's 2048-element DMA chunking
        analog, msm_api.rs:156).  `scalar_bits` is for precompute-expanded
        inputs (see `msm_precomputed`).
        """
        n = points_aff_mont.shape[0]
        c = window_bits or min(self.config.window_bits, default_window_bits(n))
        chunk = 1 << self.config.chunk_log2
        wsums = None
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            part = self.msm_partial(points_aff_mont[lo:hi], scalars[lo:hi],
                                    c, scalar_bits)
            wsums = self.accumulate(wsums, part)
        return self.finalize(wsums, c)

    def msm_precomputed(self, expanded_points, scalars, factor: int,
                        window_bits: int | None = None):
        """MSM with precomputed multiples (the reference's 8x mode).

        `expanded_points`: (factor*N, 2, L) from msm.precompute_points
        (multiple-major); `scalars`: (N, Ls) canonical limbs.  Scans only
        ceil(fr.bits/factor) bits' worth of windows."""
        from .precompute import split_scalars

        sliced, bits = split_scalars(
            scalars, factor, self.curve.spec.fr.bits
        )
        return self(expanded_points, sliced, window_bits=window_bits,
                    scalar_bits=bits)
