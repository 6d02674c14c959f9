"""Number-theoretic transform over NTT-friendly scalar fields.

The reference's NTT is a fixed 2^27 FPGA kernel fed through a 16-bank HBM
scatter/gather shuffle done on the host CPU (`/root/reference/src/ingo_ntt/
ntt_data.rs:65-156`).  Here the transform itself is computed on the device:

  * iterative radix-2 DIT butterflies after a bit-reversal permutation.
    All log2(n) stages run through ONE compiled butterfly instance inside
    a `fori_loop` — pair/twiddle indices are computed in-graph from the
    stage number, so the graph holds a single batched Montgomery multiply
    regardless of n (compile time is flat in n);
  * the full twiddle set (n/2 powers of the root) is generated on device
    at plan-build time with log2(n) batched muls (`Field.powers`) — no
    host bigint loops;
  * a four-step (Bailey) decomposition for sizes whose twiddle/working
    sets exceed a single pass — the transpose between the two passes is
    the device analog of the reference's 16-bank shuffle, and becomes an
    all_to_all over the mesh in the distributed path (dist/ntt_dist.py).

Data layout: (..., n, L) uint32 16-bit limbs, Montgomery form, natural
order in and out.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..fields.mont import Field
from ..fields.spec import FieldSpec, int_to_limbs


def _bitrev_perm(logn: int) -> np.ndarray:
    n = 1 << logn
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return rev


class NTTPlan:
    """Precomputed twiddles + permutations for one (field, logn)."""

    def __init__(self, spec: FieldSpec, logn: int):
        if logn > spec.two_adicity:
            raise ValueError(
                f"{spec.name}: 2-adicity {spec.two_adicity} < logn {logn}"
            )
        self.spec = spec
        self.field = Field(spec)
        self.logn = logn
        self.n = 1 << logn
        p, L = spec.p, spec.nlimbs
        w = spec.root_of_unity(logn)
        winv = pow(w, -1, p)
        self.w = w
        self.w_inv = winv

        def root_powers(root):
            mont = jnp.asarray(int_to_limbs((root * spec.r) % p, L))
            return self.field.powers(mont, max(self.n // 2, 1))

        # all twiddles any stage needs are powers of the base root:
        # stage s uses W^(t * n/2^(s+1)), t < 2^s — a strided subset of
        # [W^0 .. W^(n/2-1)], gathered in-graph.
        self.pow_fwd = root_powers(w)          # (n/2, L) device, Montgomery
        self.pow_inv = root_powers(winv)
        self.bitrev = jnp.asarray(_bitrev_perm(logn), dtype=jnp.int32)
        ninv = pow(self.n, -1, p)
        self.n_inv_mont = np.asarray(
            int_to_limbs((ninv * spec.r) % p, L), dtype=np.uint32
        )

    # ------------------------------------------------------------- kernels
    def _stages(self, x, pow_all):
        """x: (..., n, L) bit-reversed order in, natural order out.

        One fori_loop over stages; a single butterfly instance with
        in-graph index math (shifts by the traced stage number).
        """
        f = self.field
        n, logn = self.n, self.logn
        if logn == 0:
            return x
        half = n // 2
        j = jnp.arange(half, dtype=jnp.int32)
        ii = jnp.arange(n, dtype=jnp.int32)

        def stage(s, x):
            mask = (jnp.int32(1) << s) - 1
            lo = ((j >> s) << (s + 1)) | (j & mask)   # bit-s=0 position
            hi = lo | (jnp.int32(1) << s)
            tw_idx = (j & mask) << (self.logn - 1 - s)  # t * n/2^(s+1)
            w = jnp.take(pow_all, tw_idx, axis=0)     # (n/2, L)
            a = jnp.take(x, lo, axis=-2)
            b = jnp.take(x, hi, axis=-2)
            wb = f.mul(w, b)
            cat = jnp.concatenate([f.add(a, wb), f.sub(a, wb)], axis=-2)
            # scatter back: x'[i] lives at pair jj, half-half select
            jj = ((ii >> (s + 1)) << s) | (ii & mask)
            src = jj + ((ii >> s) & 1) * half
            return jnp.take(cat, src, axis=-2)

        return jax.lax.fori_loop(0, logn, stage, x)

    # the tables are arguments, never closed over: jit compiles a
    # closed-over array into the executable
    @property
    def fwd_tables(self):
        """(twiddle powers, bit-reversal permutation) of the forward pass."""
        return self.pow_fwd, self.bitrev

    @property
    def inv_tables(self):
        return self.pow_inv, self.bitrev

    def _fwd(self, x, pow_all, perm):
        x = jnp.take(x, perm, axis=-2)
        return self._stages(x, pow_all)

    def _inv(self, x, pow_all, perm):
        x = jnp.take(x, perm, axis=-2)
        x = self._stages(x, pow_all)
        return self.field.mul(x, jnp.asarray(self.n_inv_mont))

    @functools.cached_property
    def _fwd_jit(self):
        return jax.jit(self._fwd)

    @functools.cached_property
    def _inv_jit(self):
        return jax.jit(self._inv)

    def ntt(self, x):
        """Forward NTT, jitted. (..., n, L) Montgomery -> same."""
        return self._fwd_jit(x, *self.fwd_tables)

    def intt(self, x):
        """Inverse NTT, jitted."""
        return self._inv_jit(x, *self.inv_tables)


class FourStepNTT:
    """Bailey four-step decomposition: n = n1 * n2 (for large n).

    View coefficients as a (n1, n2) row-major matrix A (a[i] = A[i//n2,
    i%n2]).  Then NTT(a) = flatten_T( NTT_rows( twiddle * NTT_cols(A) ) ):

      1. n2 column NTTs of size n1 (batched over columns);
      2. elementwise multiply by W^(i*j), W the n-th root;
      3. n1 row NTTs of size n2 (batched over rows);
      4. output element (j, i) read as X[j*n1 + i] (transpose).

    The step-4 transpose is the reference's bank-shuffle analog
    (ntt_data.rs:80-156) and the all_to_all boundary when sharded.

    The W^(i*j) inter-pass twiddle matrix is generated on device
    (`Field.power_matrix`, n total muls in log-doubling batches) and held
    compressed as uint16 limbs — at 2^24 that is ~0.5 GiB instead of 1.
    """

    def __init__(self, spec: FieldSpec, logn: int, logn1: int | None = None):
        self.spec = spec
        self.field = Field(spec)
        self.logn = logn
        self.logn1 = logn1 if logn1 is not None else logn // 2
        self.logn2 = logn - self.logn1
        self.n1, self.n2 = 1 << self.logn1, 1 << self.logn2
        self.plan1 = NTTPlan(spec, self.logn1)
        self.plan2 = NTTPlan(spec, self.logn2)

        self.w = spec.root_of_unity(logn)
        # no global n^-1 scale needed: the sub-plans' inverse passes already
        # apply n1^-1 and n2^-1, and n1^-1 * n2^-1 == n^-1.

    # each twiddle matrix is built on first use: a forward-only client never
    # holds the inverse one (4 GiB apiece at 2^27)
    @functools.cached_property
    def _tw_fwd(self):
        return self._twiddle_matrix(self.w)

    @functools.cached_property
    def _tw_inv(self):
        return self._twiddle_matrix(pow(self.w, -1, self.spec.p))

    def _twiddle_matrix(self, w):
        """W^(i*j) for i<n1, j<n2, Montgomery form, uint16-compressed."""
        p, L = self.spec.p, self.spec.nlimbs
        mont = jnp.asarray(int_to_limbs((w * self.spec.r) % p, L))
        bases = self.field.powers(mont, self.n1)          # (n1, L)
        return Field.compress(self.field.power_matrix(bases, self.n2))

    def _fwd(self, x, tw, t1, t2):
        """tw: the twiddle matrix; t1, t2: the sub-plans' tables."""
        f = self.field
        n1, n2, L = self.n1, self.n2, self.spec.nlimbs
        a = x.reshape(*x.shape[:-2], n1, n2, L)
        # column NTTs: transform over the n1 axis (move it last-but-one)
        a = jnp.swapaxes(a, -3, -2)                 # (..., n2, n1, L)
        a = self.plan1._fwd(a, *t1)
        a = jnp.swapaxes(a, -3, -2)                 # (..., n1, n2, L)
        a = f.mul(a, Field.decompress(tw))
        a = self.plan2._fwd(a, *t2)                 # row NTTs over n2 axis
        # output index (j, i) -> X[j * n1 + i]
        a = jnp.swapaxes(a, -3, -2)                 # (..., n2, n1, L)
        return a.reshape(*x.shape[:-2], n1 * n2, L)

    def _inv(self, x, tw, t1, t2):
        f = self.field
        n1, n2, L = self.n1, self.n2, self.spec.nlimbs
        a = x.reshape(*x.shape[:-2], n2, n1, L)     # inverse of final transpose
        a = jnp.swapaxes(a, -3, -2)                 # (..., n1, n2, L)
        a = self.plan2._inv(a, *t2)
        a = f.mul(a, Field.decompress(tw))
        a = jnp.swapaxes(a, -3, -2)                 # (..., n2, n1, L)
        a = self.plan1._inv(a, *t1)
        a = jnp.swapaxes(a, -3, -2)
        return a.reshape(*x.shape[:-2], n1 * n2, L)

    @functools.cached_property
    def _fwd_jit(self):
        return jax.jit(self._fwd)

    @functools.cached_property
    def _inv_jit(self):
        return jax.jit(self._inv)

    def ntt(self, x):
        """Forward NTT; every table rides as an argument."""
        return self._fwd_jit(x, self._tw_fwd, self.plan1.fwd_tables,
                             self.plan2.fwd_tables)

    def intt(self, x):
        return self._inv_jit(x, self._tw_inv, self.plan1.inv_tables,
                             self.plan2.inv_tables)


def make_ntt(spec: FieldSpec, logn: int, four_step_threshold: int = 20):
    """Factory: the single-pass plan up to 2^four_step_threshold, the
    four-step decomposition above it."""
    if logn <= four_step_threshold:
        return NTTPlan(spec, logn)
    return FourStepNTT(spec, logn)
