"""Data-parallel MSM over a device mesh.

Points and scalars are sharded over the 'dp' axis; each device runs local
Pippenger window sums (the per-card task of the reference, which has no
multi-card story — SURVEY §2 parallelism table), then the tiny (W, 3, L)
per-window partials are all_gathered (a few KB) and tree-reduced with EC
adds before the final window fold.  Communication is O(W) points — the
reduce-side analog of the reference's final-accumulation phase counters
(msm_hw_code.rs:27,33-34).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..curves.ops import Curve
from ..msm.pippenger import MSM, MSMConfig


class DistributedMSM:
    """MSM sharded over a mesh axis. Call with globally-shaped arrays."""

    def __init__(self, curve: Curve, mesh: Mesh, axis: str = "dp",
                 config: MSMConfig | None = None):
        self.curve = curve
        self.mesh = mesh
        self.axis = axis
        self.engine = MSM(curve, config)

    def _reduce_wsums(self, gathered):
        """(D, W, 3, L) -> (W, 3, L) via log-depth batched EC adds."""
        cv = self.curve
        d = gathered.shape[0]
        while d > 1:
            half = d // 2
            merged = cv.add(gathered[:half], gathered[half : 2 * half])
            if d % 2:
                merged = jnp.concatenate([merged, gathered[2 * half : d]], 0)
            gathered = merged
            d = gathered.shape[0]
        return gathered[0]

    @functools.partial(jax.jit, static_argnums=(0, 3, 4))
    def _run(self, points, scalars, c: int, scalar_bits=None):
        def local(pts, scal):
            wsums = self.engine.msm_chunk(pts, scal, c, scalar_bits)
            gathered = jax.lax.all_gather(wsums, self.axis)      # (D, W, 3, L)
            total = self._reduce_wsums(gathered)
            return self.engine.fold_windows(total, c)            # (3, L)

        # check_vma=False: the result IS replicated (every device reduces
        # the same all_gathered wsums), but the EC tree-reduction is opaque
        # to JAX's varying-axis inference, which would reject out_specs=P().
        fn = jax.shard_map(
            local,
            mesh=self.mesh,
            in_specs=(P(self.axis), P(self.axis)),
            out_specs=P(),  # replicated result
            check_vma=False,
        )
        return fn(points, scalars)

    def __call__(self, points_aff_mont, scalars, window_bits: int | None = None,
                 scalar_bits: int | None = None):
        n = points_aff_mont.shape[0]
        d = self.mesh.shape[self.axis]
        if n % d:
            raise ValueError(f"n={n} not divisible by mesh axis {self.axis}={d}")
        from ..msm.pippenger import default_window_bits

        c = window_bits or min(
            self.engine.config.window_bits, default_window_bits(n // d)
        )
        sharding = NamedSharding(self.mesh, P(self.axis))
        pts = jax.device_put(points_aff_mont, sharding)
        scal = jax.device_put(scalars, sharding)
        return self._run(pts, scal, c, scalar_bits)
