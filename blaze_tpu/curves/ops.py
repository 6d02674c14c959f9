"""Branchless elliptic-curve group ops for y^2 = x^3 + b (a = 0).

Complete homogeneous-projective formulas from Renes-Costello-Batina 2016
(algorithms 7/8/9 for j-invariant 0): a single code path handles doubling,
inverses and the identity — exactly what a traced/vectorized device program
needs.  Points are `uint32[..., 3, L]` (X, Y, Z limb rows, Montgomery form);
identity is (0 : 1 : 0).

This supplies the math of the reference's opaque FPGA "EC adder" engines
(perf-counter surface at `/root/reference/src/ingo_msm/msm_hw_code.rs:35-54`),
and the projective z||y||x result contract parsed by its oracle
(`/root/reference/tests/msm/mod.rs:397-399` — affine = (x/z, y/z)).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..fields.mont import Field
from .spec import CurveSpec


class Curve:
    """Batched group ops bound to one CurveSpec. Stateless; jit-friendly.

    As with Field, use `jit_op('add')` etc. for standalone calls — cached
    jitted wrappers shared per curve across instances.
    """

    _JIT_CACHE: dict = {}

    def jit_op(self, name: str):
        key = (self.spec.name, name)
        fn = Curve._JIT_CACHE.get(key)
        if fn is None:
            fn = jax.jit(getattr(self, name))
            Curve._JIT_CACHE[key] = fn
        return fn

    def __init__(self, spec: CurveSpec):
        self.spec = spec
        self.fq = Field(spec.fq)
        self.fr = Field(spec.fr)
        # 3b in Montgomery form, host-side constant
        from ..fields.spec import int_to_limbs

        b3 = (3 * spec.b) % spec.fq.p
        self._b3 = np.asarray(
            int_to_limbs((b3 * spec.fq.r) % spec.fq.p, spec.fq.nlimbs),
            dtype=np.uint32,
        )

    # ------------------------------------------------------------ structure
    @property
    def nlimbs(self):
        return self.fq.nlimbs

    @staticmethod
    def pack(x, y, z):
        return jnp.stack([x, y, z], axis=-2)

    @staticmethod
    def unpack(p):
        return p[..., 0, :], p[..., 1, :], p[..., 2, :]

    def identity(self, batch_shape=()):
        f = self.fq
        return self.pack(
            f.zeros(batch_shape), f.one(batch_shape), f.zeros(batch_shape)
        )

    def is_identity(self, p):
        _, _, z = self.unpack(p)
        return self.fq.is_zero(z)

    @staticmethod
    def select(cond, p, q):
        """where(cond, p, q); cond shaped (...,)."""
        return jnp.where(cond[..., None, None], p, q)

    def neg(self, p):
        x, y, z = self.unpack(p)
        return self.pack(x, self.fq.neg(y), z)

    # ---------------------------------------------------------- group law
    def add(self, p, q):
        """Complete projective addition (RCB alg 7, a=0). 12 field muls.

        The muls are *wave-batched*: all mutually independent products are
        stacked on a new leading axis and issued as ONE batched `f.mul`
        (three waves: 6 + 2 + 6 products).  Same math, but the traced graph
        holds 3 mul subgraphs instead of 12 — tracing/compilation drops
        ~4x and the VPU sees larger fused batches.
        """
        f = self.fq
        b3 = jnp.asarray(self._b3)
        shape = jnp.broadcast_shapes(p.shape, q.shape)
        p = jnp.broadcast_to(p, shape)
        q = jnp.broadcast_to(q, shape)
        X1, Y1, Z1 = self.unpack(p)
        X2, Y2, Z2 = self.unpack(q)

        # operand sums for the cross terms, one batched add
        s = f.add(
            jnp.stack([X1, X2, Y1, Y2, X1, X2]),
            jnp.stack([Y1, Y2, Z1, Z2, Z1, Z2]),
        )
        # wave 1: all products of the inputs
        m = f.mul(
            jnp.stack([X1, Y1, Z1, s[0], s[2], s[4]]),
            jnp.stack([X2, Y2, Z2, s[1], s[3], s[5]]),
        )
        m0, m1, m2 = m[0], m[1], m[2]            # X1X2, Y1Y2, Z1Z2
        u = f.add(jnp.stack([m0, m1, m0, m0]), jnp.stack([m1, m2, m2, m0]))
        v = f.sub(m[3:6], u[0:3])                # t3, t4, t5 cross sums
        t3, t4, t5 = v[0], v[1], v[2]
        t0 = f.add(u[3], m0)                     # 3 X1X2
        # wave 2: constant products with b3
        w = f.mul(b3, jnp.stack([m2, t5]))
        z3 = f.add(m1, w[0])                     # Y1Y2 + 3bZ1Z2
        t1 = f.sub(m1, w[0])                     # Y1Y2 - 3bZ1Z2
        # wave 3: output products
        r = f.mul(
            jnp.stack([t3, t4, t1, t0, z3, t0]),
            jnp.stack([t1, w[1], z3, w[1], t4, t3]),
        )
        X3 = f.sub(r[0], r[1])
        Y3 = f.add(r[2], r[3])
        Z3 = f.add(r[4], r[5])
        return self.pack(X3, Y3, Z3)

    def add_mixed(self, p, q_affine):
        """Complete mixed addition (RCB alg 8, a=0), q affine (x, y) stacked
        as uint32[..., 2, L]. 11 field muls, wave-batched (5 + 2 + 6; see
        `add`). Handles p = identity; q must be a real point (affine
        encoding cannot express the identity)."""
        f = self.fq
        b3 = jnp.asarray(self._b3)
        shape = jnp.broadcast_shapes(p.shape[:-2], q_affine.shape[:-2])
        p = jnp.broadcast_to(p, (*shape, 3, p.shape[-1]))
        q_affine = jnp.broadcast_to(q_affine, (*shape, 2, q_affine.shape[-1]))
        X1, Y1, Z1 = self.unpack(p)
        X2, Y2 = q_affine[..., 0, :], q_affine[..., 1, :]

        s = f.add(jnp.stack([X1, X2]), jnp.stack([Y1, Y2]))
        # wave 1: X1X2, Y1Y2, (X1+Y1)(X2+Y2), Y2Z1, X2Z1
        m = f.mul(
            jnp.stack([X1, Y1, s[0], Y2, X2]),
            jnp.stack([X2, Y2, s[1], Z1, Z1]),
        )
        m0, m1 = m[0], m[1]
        u = f.add(
            jnp.stack([m0, m[3], m[4], m0]),
            jnp.stack([m1, Y1, X1, m0]),
        )
        t3 = f.sub(m[2], u[0])                   # X1Y2 + X2Y1
        t4 = u[1]                                # Y1 + Y2Z1
        t0 = f.add(u[3], m0)                     # 3 X1X2
        # wave 2: b3*Z1, b3*(X1 + X2Z1)
        w = f.mul(b3, jnp.stack([Z1, u[2]]))
        z3 = f.add(m1, w[0])
        t1 = f.sub(m1, w[0])
        # wave 3
        r = f.mul(
            jnp.stack([t3, t4, t1, t0, z3, t0]),
            jnp.stack([t1, w[1], z3, w[1], t4, t3]),
        )
        X3 = f.sub(r[0], r[1])
        Y3 = f.add(r[2], r[3])
        Z3 = f.add(r[4], r[5])
        return self.pack(X3, Y3, Z3)

    def dbl(self, p):
        """Complete doubling (RCB alg 9, a=0). 6M + 2S, wave-batched
        (4 + 1 + 4; see `add`)."""
        f = self.fq
        b3 = jnp.asarray(self._b3)
        X, Y, Z = self.unpack(p)

        # wave 1: Y^2, YZ, Z^2, XY
        m = f.mul(jnp.stack([Y, Y, Z, X]), jnp.stack([Y, Z, Z, Y]))
        t0 = m[0]
        d1 = f.add(m[0], m[0])
        d2 = f.add(d1, d1)
        z3 = f.add(d2, d2)                       # 8 Y^2
        # wave 2: b3 Z^2
        t2 = f.mul(b3, m[2])
        y3p = f.add(t0, t2)                      # Y^2 + 3bZ^2
        t2_3 = f.add(f.add(t2, t2), t2)          # 9b Z^2
        t0 = f.sub(t0, t2_3)                     # Y^2 - 9bZ^2
        # wave 3: (3bZ^2)(8Y^2), (YZ)(8Y^2), (Y^2-9bZ^2)(Y^2+3bZ^2),
        #         (Y^2-9bZ^2)(XY)
        r = f.mul(jnp.stack([t2, m[1], t0, t0]),
                  jnp.stack([z3, z3, y3p, m[3]]))
        Y3 = f.add(r[0], r[2])
        X3 = f.add(r[3], r[3])
        Z3 = r[1]
        return self.pack(X3, Y3, Z3)

    # ------------------------------------------------------------- checks
    def on_curve(self, p):
        """Projective check: Y^2 Z == X^3 + b Z^3 (identity passes)."""
        f = self.fq
        X, Y, Z = self.unpack(p)
        # scale both sides by 3 so the precomputed 3b constant can be used:
        #   3 Y^2 Z == 3 X^3 + (3b) Z^3
        lhs = f.mul(f.square(Y), Z)
        lhs3 = f.add(f.double(lhs), lhs)
        x3 = f.mul(f.square(X), X)
        rhs3 = f.add(
            f.add(f.double(x3), x3),
            f.mul(jnp.asarray(self._b3), f.mul(f.square(Z), Z)),
        )
        return f.eq(lhs3, rhs3)

    # --------------------------------------------------------- conversions
    def to_affine(self, p):
        """Projective -> affine (..., 2, L); identity maps to (0, 0)."""
        f = self.fq
        X, Y, Z = self.unpack(p)
        zinv = f.inv(Z)
        ax = f.mul(X, zinv)
        ay = f.mul(Y, zinv)
        return jnp.stack([ax, ay], axis=-2)

    def from_affine(self, q_affine):
        """Affine (..., 2, L) -> projective with Z = 1 (Montgomery one)."""
        x = q_affine[..., 0, :]
        y = q_affine[..., 1, :]
        one = self.fq.one(x.shape[:-1])
        return self.pack(x, y, one)

    # -------------------------------------------------------- scalar mul
    def scalar_mul(self, p, k: int):
        """p * k for a python-int scalar (test/oracle use).

        Fixed-width double-and-add via fori_loop so the graph stays small
        (one dbl+add body) regardless of scalar size.
        """
        nbits = self.spec.fr.bits
        k %= self.spec.fr.p
        kbits = jnp.asarray(
            [(k >> (nbits - 1 - i)) & 1 for i in range(nbits)], dtype=jnp.uint32
        )

        def body(i, acc):
            acc = self.dbl(acc)
            added = self.add(acc, p)
            take = jnp.broadcast_to(kbits[i] == 1, acc.shape[:-2])
            return self.select(take, added, acc)

        init = self.identity(p.shape[:-2])
        return jax.lax.fori_loop(0, nbits, body, init)
