"""Vectorized Montgomery arithmetic on 16-bit limbs in uint32 lanes.

All ops act on `uint32[..., L]` arrays (little-endian limbs, each < 2^16,
value < p, Montgomery form) and are elementwise over every leading batch
dimension — they trace to plain integer elementwise code under `jax.jit`
that XLA fuses on the GPU and runs unchanged on CPU.  This replaces the
FPGA field cores the reference drives blindly (its point/scalar byte widths:
`/root/reference/src/ingo_msm/msm_cfg.rs:44-92`).

Design notes (correctness invariants):
  * full 16x16 limb products are exact in uint32;
  * lazy-carry column accumulation: each column of the double-width product
    receives <= 2L terms, each < 2^16, plus reduction terms — bounded by
    4L * 2^16 < 2^23 for L <= 24, no uint32 overflow;
  * Montgomery reduction is interleaved per-limb with an explicit running
    carry, so `m = t_i * n0inv mod 2^16` sees the fully-normalized limb;
  * the result before final conditional subtraction is < 2p (requires
    R > 4p, true for every supported field), so one branchless
    select-subtract restores the canonical `< p` range.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .spec import FieldSpec, LIMB_BITS, LIMB_MASK, int_to_limbs, limbs_to_int

_U32 = jnp.uint32


class Field:
    """Batched field ops bound to one FieldSpec. Stateless; jit-friendly.

    Methods are designed to be called inside larger jitted programs.  For
    standalone use (tests, host-side glue) use `jit_op('mul')` etc. — cached
    jitted wrappers, one compile per (op, shape) per process, persisted in
    the XLA compilation cache across processes.
    """

    _JIT_CACHE: dict = {}

    def jit_op(self, name: str):
        key = (self.spec.name, name)
        fn = Field._JIT_CACHE.get(key)
        if fn is None:
            fn = jax.jit(getattr(self, name))
            Field._JIT_CACHE[key] = fn
        return fn

    def __init__(self, spec: FieldSpec):
        self.spec = spec
        self.nlimbs = spec.nlimbs
        self._p = np.asarray(spec.p_limbs, dtype=np.uint32)
        self._r2 = np.asarray(spec.r2_limbs, dtype=np.uint32)
        self._one = np.asarray(spec.one_mont_limbs, dtype=np.uint32)
        self._n0inv = int(spec.n0inv)
        # REDC bound: with canonical inputs (< p), t = (ab + mp)/R < 2p
        # already when R > p; we always conditionally subtract back to < p.
        assert spec.r > spec.p, "Montgomery radix must exceed the modulus"

    # ------------------------------------------------------------------ util
    def zeros(self, batch_shape=()):
        return jnp.zeros((*batch_shape, self.nlimbs), dtype=_U32)

    def one(self, batch_shape=()):
        return jnp.broadcast_to(
            jnp.asarray(self._one), (*batch_shape, self.nlimbs)
        ).astype(_U32)

    def is_zero(self, a):
        """Boolean (...,) — true where the element is 0 (any domain)."""
        return jnp.all(a == 0, axis=-1)

    def eq(self, a, b):
        return jnp.all(a == b, axis=-1)

    @staticmethod
    def select(cond, a, b):
        """where(cond, a, b) with cond shaped (...,) broadcast over limbs."""
        return jnp.where(cond[..., None], a, b)

    # ------------------------------------------------------ carry primitives
    @staticmethod
    def _shift_limbs(v, d: int):
        """v shifted up by d positions along the limb axis (zero-fill)."""
        pad = [(0, 0)] * (v.ndim - 1) + [(d, 0)]
        return jnp.pad(v[..., :-d] if d else v, pad if d else [(0, 0)] * v.ndim)

    @staticmethod
    def _kogge_stone(g, p):
        """Carry-lookahead combine over the limb axis (inclusive scan).

        g, p: uint32[..., W] generate/propagate flags (0/1).  Returns G with
        G[..., j] = carry generated by limbs [0..j] assuming zero carry-in:
        G_j = g_j | (p_j & g_{j-1}) | (p_j & p_{j-1} & g_{j-2}) | ...
        log2(W) vectorized rounds — no sequential limb chain, so both XLA
        compile time and device runtime are O(log W) instead of O(W).
        """
        d = 1
        W = g.shape[-1]
        while d < W:
            g = g | (p & Field._shift_limbs(g, d))
            p = p & Field._shift_limbs(p, d)
            d *= 2
        return g

    def _normalize(self, cols, carry_in=None):
        """Propagate carries over `cols` (values < 2^31). Returns (limbs, top).

        limbs are < 2^16; `top` is whatever carries out of the last limb.
        Vectorized carry-lookahead:
          t_j = (cols_j & mask) + (cols_{j-1} >> 16)   [+ carry_in at j=0]
        puts every limb within one unit carry of final (t_j < 2^17, and the
        generate/propagate case g_j = p_j = 1 is impossible for j >= 1 since
        t_j < 2^16 + 2^15 there; at j = 0 carry-in is structurally 0), so a
        single Kogge-Stone pass resolves all ripple.
        """
        lo = cols & LIMB_MASK
        hi = cols >> LIMB_BITS                      # each < 2^15
        t = lo + self._shift_limbs(hi, 1)
        if carry_in is not None:
            t = t.at[..., 0].add(carry_in)
        g = t >> LIMB_BITS                          # in {0, 1}
        p = ((t & LIMB_MASK) == LIMB_MASK).astype(_U32)
        G = self._kogge_stone(g, p)
        carries = self._shift_limbs(G, 1)           # carry INTO limb j
        limbs = (t + carries) & LIMB_MASK
        top = hi[..., -1] + G[..., -1]
        return limbs, top

    def _sub_limbs(self, x, y):
        """(x - y) mod 2^(16L) with borrow lookahead. Returns (limbs, borrow).

        u_j = x_j + 2^16 - y_j is in [1, 2^17); borrow-generate
        g_j = 1 - (u_j >> 16), borrow-propagate p_j = ((u_j & mask) == 0)
        (u_j = 2^16 exactly: limb 0 with no borrow — an incoming borrow
        flips it to 0xFFFF and re-borrows).  g_j & p_j is impossible
        (u_j = 0 can't occur), so one Kogge-Stone pass is exact.
        """
        u = x + jnp.uint32(1 << LIMB_BITS) - y
        g = jnp.uint32(1) - (u >> LIMB_BITS)
        p = ((u & LIMB_MASK) == 0).astype(_U32)
        G = self._kogge_stone(g, p)
        borrows = self._shift_limbs(G, 1)           # borrow INTO limb j
        limbs = (u - borrows) & LIMB_MASK
        return limbs, G[..., -1]

    def _cond_sub_p(self, limbs, extra_top):
        """Reduce a value `extra_top * 2^(16L) + limbs` < 2p into [0, p)."""
        p = jnp.asarray(self._p)
        sub, borrow = self._sub_limbs(limbs, jnp.broadcast_to(p, limbs.shape))
        ge = (extra_top > 0) | (borrow == 0)
        return self.select(ge, sub, limbs)

    # -------------------------------------------------------------- add/sub
    def add(self, a, b):
        limbs, top = self._normalize(a + b)
        return self._cond_sub_p(limbs, top)

    def sub(self, a, b):
        d, borrow = self._sub_limbs(a, b)
        # if borrowed, add p back (cannot re-borrow since p - (b - a) > 0)
        fixed, _ = self._normalize(d + jnp.asarray(self._p))
        return self.select(borrow > 0, fixed, d)

    def neg(self, a):
        p = jnp.broadcast_to(jnp.asarray(self._p), a.shape)
        d, _ = self._sub_limbs(p, a)
        return self.select(self.is_zero(a), a, d)

    def double(self, a):
        return self.add(a, a)

    # ------------------------------------------------------------------ mul
    def _conv_cols(self, a, b, width: int):
        """Lazy-carry column sums of the integer product a*b.

        a, b: uint32[..., La/Lb] with normalized (< 2^16) limbs.  Returns
        uint32[..., width] where column k holds sum_{i+j=k} a_i * b_j split
        into 16-bit lo/hi contributions — each column < 2*min(La,Lb) * 2^16,
        far below uint32 overflow for L <= 24.

        Shear-reshape formulation: one batched limb outer product, then
        each row i is shifted right by i columns via a single
        pad→flatten→truncate→reshape (row i of an (Lb, W+1) matrix lands at
        flat offset i*(W+1)+j = target index i*W + (i+j) of an (Lb, W)
        view), and the anti-diagonal sums drop out as one axis reduction.
        O(1) XLA ops regardless of limb count — both compile time and
        device runtime beat the 2*Lb-term pad/add chain this replaces.
        """
        La, Lb = a.shape[-1], b.shape[-1]
        batch = jnp.broadcast_shapes(a.shape[:-1], b.shape[:-1])
        prod = a[..., None, :] * b[..., :, None]        # (*batch, Lb, La)
        lo = prod & LIMB_MASK
        hi = prod >> LIMB_BITS
        nd = prod.ndim
        # row i := lo_i at offset 0 + hi_i at offset 1 (values < 2^17)
        rows = (
            jnp.pad(lo, [(0, 0)] * (nd - 1) + [(0, 1)])
            + jnp.pad(hi, [(0, 0)] * (nd - 1) + [(1, 0)])
        )                                                # (*batch, Lb, La+1)
        W = max(width, La + Lb + 1)
        rows = jnp.pad(rows, [(0, 0)] * (nd - 1) + [(0, W + 1 - (La + 1))])
        flat = rows.reshape(*batch, Lb * (W + 1))[..., : Lb * W]
        sheared = flat.reshape(*batch, Lb, W)            # row i shifted by i
        return sheared.sum(axis=-2, dtype=_U32)[..., :width]

    def mul(self, a, b):
        """Montgomery product a*b*R^-1 mod p. a, b: uint32[..., L].

        Full-width REDC: T = a*b; m = (T mod R) * N' mod R with
        N' = -p^-1 mod R; result = (T + m*p) / R < 2p, then one
        conditional subtraction.  Three independent convolution phases +
        three short carry chains — a structure XLA fuses well (the
        classic limb-serial CIOS interleaving of narrow carries with wide
        updates compiles catastrophically slowly).
        """
        L = self.nlimbs
        W = 2 * L + 1
        p = jnp.asarray(self._p)
        nprime = jnp.asarray(np.asarray(self.spec.nprime_limbs, dtype=np.uint32))

        t = self._conv_cols(a, b, W)                     # columns of a*b
        t_lo, c_lo = self._normalize(t[..., :L])         # T mod R, carry into col L
        m_cols = self._conv_cols(t_lo, nprime, L)        # low half of T_lo * N'
        m, _ = self._normalize(m_cols)                   # m = ... mod R
        q = self._conv_cols(m, p, W)                     # columns of m*p

        # U = T + m*p; U mod R == 0, so only the carry out of the low half
        # survives.  c1 = (T_lo + (m*p)_lo) / R.
        _, c1 = self._normalize(t_lo + q[..., :L])
        hi = t[..., L : 2 * L] + q[..., L : 2 * L]
        limbs, top = self._normalize(hi, carry_in=c1 + c_lo)
        top = top + t[..., 2 * L] + q[..., 2 * L]
        return self._cond_sub_p(limbs, top)

    def square(self, a):
        return self.mul(a, a)

    # --------------------------------------------------------- domain moves
    def to_mont(self, a):
        return self.mul(a, jnp.asarray(self._r2))

    def from_mont(self, a):
        one = jnp.zeros_like(a).at[..., 0].set(1)
        return self.mul(a, one)

    # ------------------------------------------------------------------ pow
    def pow(self, a, e: int):
        """a^e for a fixed python-int exponent. Runs a fori_loop over bits."""
        nbits = max(e.bit_length(), 1)
        ebits = jnp.asarray(
            [(e >> i) & 1 for i in range(nbits)], dtype=jnp.uint32
        )

        def body(i, acc):
            bit = ebits[nbits - 1 - i]
            acc = self.square(acc)
            withmul = self.mul(acc, a)
            return self.select(
                jnp.broadcast_to(bit, acc.shape[:-1]) == 1, withmul, acc
            )

        init = self.one(a.shape[:-1])
        return jax.lax.fori_loop(0, nbits, body, init)

    def inv(self, a):
        """Batched inverse via Fermat: a^(p-2). inv(0) = 0."""
        return self.pow(a, self.spec.p - 2)

    # ------------------------------------------------------------ power sets
    def powers(self, base_mont, n: int):
        """[b^0, b^1, ..., b^(n-1)] as (n, L) Montgomery limbs.

        Log-doubling: log2(n) batched muls (device-side) — the twiddle
        generator for NTT plans (the reference precomputes nothing: its
        twiddles live inside the opaque FPGA kernel).
        """
        out = self.one((1,))
        if n <= 1:
            return out[:n]
        mulj = self.jit_op("mul")
        cur = jnp.asarray(base_mont)[None]          # b^(2^k) walker
        while out.shape[0] < n:
            k = out.shape[0]
            take = min(k, n - k)
            nxt = mulj(out[:take], cur)             # b^k .. b^(k+take-1)
            out = jnp.concatenate([out, nxt], axis=0)
            if out.shape[0] < n:
                cur = mulj(cur, cur)
        return out

    def power_matrix(self, bases_mont, m: int):
        """(n, L) bases -> (n, m, L) matrix M[i, j] = bases[i]^j.

        Log-doubling along j with the whole base column batched: log2(m)
        muls, n*m total field-mul work, all on device.
        """
        n = bases_mont.shape[0]
        out = self.one((n, 1))
        if m <= 1:
            return out[:, :m]
        mulj = self.jit_op("mul")
        cur = bases_mont[:, None, :]                # bases^(2^k) walker
        while out.shape[1] < m:
            k = out.shape[1]
            take = min(k, m - k)
            nxt = mulj(out[:, :take], cur)
            out = jnp.concatenate([out, nxt], axis=1)
            if out.shape[1] < m:
                cur = mulj(cur, cur)
        return out

    # ------------------------------------------------------- host transfers
    def from_int(self, x, batch_shape=(), mont=True):
        """Python int(s) -> device limbs (Montgomery by default)."""
        if isinstance(x, int):
            arr = np.broadcast_to(
                int_to_limbs(x % self.spec.p, self.nlimbs),
                (*batch_shape, self.nlimbs),
            )
        else:
            xs = list(x)
            arr = np.stack(
                [int_to_limbs(v % self.spec.p, self.nlimbs) for v in xs]
            )
        out = jnp.asarray(arr, dtype=_U32)
        return self.jit_op("to_mont")(out) if mont else out

    def to_int(self, a, mont=True):
        """Device limbs -> python int or nested list of ints."""
        if mont:
            a = self.jit_op("from_mont")(a)
        arr = np.asarray(jax.device_get(a), dtype=np.uint64)
        flat = arr.reshape(-1, self.nlimbs)
        vals = [limbs_to_int(row) for row in flat]
        if arr.ndim == 1:
            return vals[0]
        out = np.empty(arr.shape[:-1], dtype=object)
        out.reshape(-1)[:] = vals
        return out.tolist() if out.ndim else vals[0]

    # ------------------------------------------------------- compact storage
    @staticmethod
    def compress(a):
        """uint32 limbs -> uint16 storage (halves the device footprint)."""
        return a.astype(jnp.uint16)

    @staticmethod
    def decompress(a):
        return a.astype(_U32)
