"""Sharded four-step NTT: local sub-NTTs + all_to_all stage exchange.

This replaces the reference's 16-HBM-bank scatter/gather shuffle
(`reference/src/ingo_ntt/ntt_data.rs:80-156`) — a *within-card,
host-CPU* all-to-all.  Here the coefficient matrix is sharded over a mesh
axis and the inter-stage transpose is a real `jax.lax.all_to_all` over
the device interconnect (NVLink between the GPUs of one host).

Decomposition (n = n1 * n2, A[i1][i2] = a[i1*n2 + i2]):
  1. column NTTs (size n1) — shard over i2, local;
  2. twiddle W^(k1*i2) — sharded with the data;
  3. all_to_all: i2-sharded -> k1-sharded;
  4. row NTTs (size n2) — local;
  5. optional second all_to_all for natural output order.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..fields.mont import Field
from ..fields.spec import FieldSpec, int_to_limbs
from ..ntt.transform import NTTPlan


class DistributedNTT:
    def __init__(self, spec: FieldSpec, logn: int, mesh: Mesh,
                 axis: str = "sp", logn1: int | None = None):
        self.spec = spec
        self.field = Field(spec)
        self.mesh = mesh
        self.axis = axis
        self.ndev = mesh.shape[axis]
        self.logn = logn
        self.logn1 = logn1 if logn1 is not None else logn // 2
        self.logn2 = logn - self.logn1
        self.n1, self.n2 = 1 << self.logn1, 1 << self.logn2
        if self.n1 % self.ndev or self.n2 % self.ndev:
            raise ValueError(
                f"n1={self.n1}, n2={self.n2} must divide by {self.ndev} devices"
            )
        self.plan1 = NTTPlan(spec, self.logn1)
        self.plan2 = NTTPlan(spec, self.logn2)
        self.w = spec.root_of_unity(logn)

    # built on first use: forward-only callers never compile or hold the
    # inverse matrix
    @functools.cached_property
    def _tw(self):
        """(n1, n2, L) u16 forward twiddles, sharded over the axis."""
        return self._twiddle_matrix(self.w)

    @functools.cached_property
    def _tw_inv(self):
        return self._twiddle_matrix(pow(self.w, -1, self.spec.p))

    def _twiddle_matrix(self, w):
        """W^(i*j), Montgomery, uint16-compressed, generated SHARDED.

        The matrix is the working set that breaks single-device generation
        at 2^27 (~6.4 GiB compressed): each device builds only its own
        (n1, n2/D) column block in-place via
            W^(i*(j_off+j)) = (W^(j_off))^i * (W^i)^j
        — a per-device shift column (log-doubling powers of the host-
        computed W^(j_off)) times the replicated base power matrix.  No
        twiddle bytes ever cross devices.
        """
        p, L = self.spec.p, self.spec.nlimbs
        D = self.ndev
        n2l = self.n2 // D
        f = self.field
        mont_w = jnp.asarray(int_to_limbs((w * self.spec.r) % p, L))
        # per-device W^(d * n2l) in Montgomery form (host bigint pow)
        wj = np.stack([
            np.asarray(
                int_to_limbs((pow(w, d * n2l, p) * self.spec.r) % p, L),
                dtype=np.uint32,
            )
            for d in range(D)
        ])

        def local(wj_l):                             # (1, L) this device's W^(j_off)
            bases = f.powers(mont_w, self.n1)        # (n1, L) replicated compute
            shift = f.powers(wj_l[0], self.n1)       # (n1, L) = (W^(j_off))^i
            pm = f.power_matrix(bases, n2l)          # (n1, n2/D, L)
            return Field.compress(f.mul(pm, shift[:, None, :]))

        gen = jax.jit(jax.shard_map(
            local, mesh=self.mesh, in_specs=(P(self.axis),),
            out_specs=P(None, self.axis),
        ))
        wj_dev = jax.device_put(
            jnp.asarray(wj), NamedSharding(self.mesh, P(self.axis))
        )
        return gen(wj_dev)

    # the sub-plans' tables, replicated over the mesh once
    @functools.cached_property
    def _fwd_tables(self):
        return jax.device_put((self.plan1.fwd_tables, self.plan2.fwd_tables),
                              NamedSharding(self.mesh, P()))

    @functools.cached_property
    def _inv_tables(self):
        return jax.device_put((self.plan1.inv_tables, self.plan2.inv_tables),
                              NamedSharding(self.mesh, P()))

    # ---------------------------------------------------------------- fwd
    def _local_fwd(self, a, tw, t1, t2):
        """a: (n1, n2/D, L) — this device's column shard (i2 range);
        t1, t2: the sub-plans' tables."""
        f = self.field
        # 1. column NTTs over i1 (axis 0): move to -2 for the plan
        a = jnp.swapaxes(a, 0, 1)                   # (n2/D, n1, L)
        a = self.plan1._fwd(a, *t1)
        a = jnp.swapaxes(a, 0, 1)                   # (n1, n2/D, L) — now k1
        # 2. twiddle (sharded operand has matching i2 slice)
        a = f.mul(a, tw)
        # 3. transpose exchange: i2-sharded -> k1-sharded
        #    split k1 (axis 0) into D chunks, concat received on i2 axis
        a = jax.lax.all_to_all(
            a, self.axis, split_axis=0, concat_axis=1, tiled=True
        )                                            # (n1/D, n2, L)
        # 4. row NTTs over i2
        a = self.plan2._fwd(a, *t2)                  # (n1/D, n2, L) — k2
        return a

    @functools.partial(jax.jit, static_argnums=(0, 4))
    def _run(self, x, tw, tables, inverse: bool):
        """tw: the sharded u16 twiddles; tables: the sub-plans' replicated
        tables.  Both are arguments (jit would compile a closed-over array
        into the executable)."""
        f = self.field

        def fwd_local(a, twl, tabs):
            # decompress per-shard so the u32 twiddle temp never exceeds
            # one device's block
            return self._local_fwd(a, twl.astype(jnp.uint32), *tabs)

        def inv_local(x_k, twl, tabs):
            t1, t2 = tabs
            # x_k: (n1/D, n2, L) k1-sharded spectral data
            a = self.plan2._inv(x_k, *t2)            # undo row NTTs
            a = jax.lax.all_to_all(
                a, self.axis, split_axis=1, concat_axis=0, tiled=True
            )                                        # (n1, n2/D, L) i2-shard
            a = f.mul(a, twl.astype(jnp.uint32))
            a = jnp.swapaxes(a, 0, 1)
            a = self.plan1._inv(a, *t1)
            return jnp.swapaxes(a, 0, 1)             # (n1, n2/D, L)

        if inverse:
            fn = jax.shard_map(
                inv_local, mesh=self.mesh,
                in_specs=(P(self.axis), P(None, self.axis), P()),
                out_specs=P(None, self.axis),
            )
            return fn(x, tw, tables)
        fn = jax.shard_map(
            fwd_local, mesh=self.mesh,
            in_specs=(P(None, self.axis), P(None, self.axis), P()),
            out_specs=P(self.axis),
        )
        return fn(x, tw, tables)

    # ------------------------------------------------------------- public
    def ntt(self, x):
        """x: (n, L) Montgomery, natural order -> spectral (n1-major
        (k1, k2) matrix, k1-sharded): X[k1 + n1*k2] = out[k1, k2]."""
        a = x.reshape(self.n1, self.n2, -1)
        return self._run(a, self._tw, self._fwd_tables, False)

    def intt(self, xk):
        """Inverse of ntt(): takes the (n1, n2) k-matrix, returns (n, L)."""
        a = self._run(xk, self._tw_inv, self._inv_tables, True)
        return a.reshape(self.n1 * self.n2, -1)

    def spectral_to_natural(self, xk):
        """(k1, k2) matrix -> natural-order vector X[k] (host-side helper)."""
        return jnp.swapaxes(xk, 0, 1).reshape(self.n1 * self.n2, -1)
