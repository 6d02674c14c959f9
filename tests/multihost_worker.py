"""Per-process worker for the 2-process localhost jax.distributed test.

Exercises the REAL multi-host bootstrap path (dist/mesh.py
init_distributed -> jax.distributed.initialize) that a multi-host
deployment uses, on CPU: 2 processes x 2 virtual devices = a 4-device global mesh,
one data-parallel MSM sharded over it, oracle-checked in every process.
This is the measurement surface the reference cannot have (it is
single-card; multi-card orchestration is explicitly left to "the
management layer", /root/reference/README.md:20-22).

Usage: python multihost_worker.py <process_id> <num_processes> <port>
"""
import os
import sys

PID = int(sys.argv[1])
NPROC = int(sys.argv[2])
PORT = sys.argv[3]

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=2"
)

import jax  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from blaze_tpu.dist import DistributedMSM, init_distributed, make_mesh  # noqa: E402
from blaze_tpu.curves import CURVES, Curve  # noqa: E402
from blaze_tpu.oracle import tiled_msm_instance  # noqa: E402
from blaze_tpu.utils.cache import setup_compile_cache  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# Per-process cache directory: two processes reading and writing one
# cache directory at once have crashed in its decompression.
setup_compile_cache(subdir=f"mh{PID}")


def main() -> int:
    init_distributed(
        coordinator=f"127.0.0.1:{PORT}", num_processes=NPROC, process_id=PID
    )
    assert jax.process_count() == NPROC, jax.process_count()
    ndev = len(jax.devices())
    assert ndev == 2 * NPROC, ndev

    spec = CURVES["bn254"]
    curve = Curve(spec)
    mesh = make_mesh({"dp": ndev})
    n = 8 * ndev
    points, scalars, _, _ = tiled_msm_instance(spec, n, seed=29)
    # mask scalars to 8 bits: 2 windows instead of 64 keeps the cold
    # XLA:CPU compile small while the sharding layout stays identical
    scal = np.asarray(scalars).copy()
    scal[:, 0] &= 0xFF
    scal[:, 1:] = 0

    pts_mont = np.asarray(curve.fq.to_mont(jnp.asarray(points)))

    # every process holds the same global input; shards materialize only
    # on addressable devices
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P("dp"))
    pts = jax.make_array_from_callback(
        pts_mont.shape, sharding, lambda idx: pts_mont[idx]
    )
    sc = jax.make_array_from_callback(
        scal.shape, sharding, lambda idx: scal[idx]
    )

    dmsm = DistributedMSM(curve, mesh, axis="dp")
    # AOT-compile FIRST, then rendezvous: gloo's collective-context
    # handshake times out after 30 s, and on a loaded host the other
    # process can easily still be compiling when this one executes.
    run2 = jax.jit(lambda p, s: dmsm._run(p, s, 4, 8))
    compiled = run2.lower(pts, sc).compile()
    from jax._src import distributed as _dist

    _dist.global_state.client.wait_at_barrier("blz_compiled", 900_000)
    out = compiled(pts, sc)
    jax.block_until_ready(out)

    # oracle check (host bigint) in every process
    from blaze_tpu.oracle import ECOracle

    aff = curve.to_affine(np.asarray(out)[None])[0]
    got = (curve.fq.to_int(aff[0]), curve.fq.to_int(aff[1]))
    pts_int = [
        (
            int(sum(int(v) << (16 * i) for i, v in enumerate(p[0]))),
            int(sum(int(v) << (16 * i) for i, v in enumerate(p[1]))),
        )
        for p in np.asarray(points)
    ]
    expected = ECOracle(spec).msm(pts_int, [int(s[0]) for s in scal])
    assert got == expected, f"proc {PID}: {got} != {expected}"
    print(f"proc {PID}/{NPROC}: 4-device 2-process MSM oracle-exact", flush=True)
    jax.distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
