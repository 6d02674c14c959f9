"""Batched Poseidon permutation and sponge hash.

The compute core the reference's FPGA hash engine performs opaquely
(`/root/reference/src/ingo_hash/poseidon_api.rs`): x^5 S-box, MDS mix,
round-constant adds.  All ops are batched field ops over (batch, t, L)
Montgomery limb arrays; the round loop is three `fori_loop`s (full /
partial / full) so the traced graph holds a single round body each.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..fields.mont import Field
from .params import PoseidonParams


class Poseidon:
    def __init__(self, params: PoseidonParams):
        self.params = params
        self.field = Field(params.spec)

    # ---------------------------------------------------------- primitives
    def _sbox(self, x):
        f = self.field
        x2 = f.square(x)
        x4 = f.square(x2)
        return f.mul(x4, x)  # x^5

    def _mds(self, state):
        """state (..., t, L) -> MDS @ state with field arithmetic."""
        f = self.field
        t = self.params.t
        m = jnp.asarray(self.params.mds_mont)           # (t, t, L)
        prod = f.mul(m, state[..., None, :, :])          # (..., t, t, L)
        # tree-sum over the contraction axis j (axis -2 of (..., i, j, L))
        width = t
        while width > 1:
            half = width // 2
            prod = jnp.concatenate(
                [
                    f.add(prod[..., :half, :], prod[..., half : 2 * half, :]),
                    prod[..., 2 * half : width, :],
                ],
                axis=-2,
            )
            width = half + (width - 2 * half)
        return prod[..., 0, :]

    def _round(self, state, rc, full: bool):
        f = self.field
        state = f.add(state, rc)
        if full:
            state = self._sbox(state)
        else:
            first = self._sbox(state[..., :1, :])
            state = jnp.concatenate([first, state[..., 1:, :]], axis=-2)
        return self._mds(state)

    # ---------------------------------------------------------- permutation
    def _permute(self, state):
        """(..., t, L) Montgomery -> (..., t, L)."""
        p = self.params
        rc = jnp.asarray(p.rc_mont)  # (rounds, t, L)
        half_f = p.r_f // 2

        def full_round(i, s):
            return self._round(s, rc[i], full=True)

        def partial_round(i, s):
            return self._round(s, rc[i], full=False)

        state = jax.lax.fori_loop(0, half_f, full_round, state)
        state = jax.lax.fori_loop(half_f, half_f + p.r_p, partial_round, state)
        state = jax.lax.fori_loop(
            half_f + p.r_p, p.r_f + p.r_p, full_round, state
        )
        return state

    @functools.cached_property
    def permute(self):
        return jax.jit(self._permute)

    # ---------------------------------------------------------------- hash
    def _hash(self, inputs, domain_tag):
        """One-shot sponge: state = [domain_tag, inputs...]; out = state[1].

        inputs: (..., rate, L) Montgomery.  domain_tag: (L,) Montgomery.
        """
        batch = inputs.shape[:-2]
        L = inputs.shape[-1]
        tag = jnp.broadcast_to(domain_tag, (*batch, 1, L))
        state = jnp.concatenate([tag, inputs], axis=-2)
        out = self._permute(state)
        return out[..., 1, :]

    @functools.cached_property
    def hash(self):
        return jax.jit(self._hash)

    def domain_tag(self, value: int):
        """Montgomery-form (L,) constant for a python-int tag."""
        from ..fields.spec import int_to_limbs

        spec = self.params.spec
        return jnp.asarray(
            int_to_limbs((value * spec.r) % spec.p, spec.nlimbs),
            dtype=jnp.uint32,
        )
