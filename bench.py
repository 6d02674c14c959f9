#!/usr/bin/env python
"""Benchmark of the three primitives and the NTT -> MSM pipeline on one GPU.

Prints one JSON line.  The headline metric is the BLS12-381 MSM
(points/sec); `extra` carries the NTT, Poseidon and pipeline legs.  Every
record names the device it ran on (platform, device_kind, device count,
the card's name and power limit) and the leg's device peak bytes.  With
no GPU the bench fails; a leg that fails makes the exit code non-zero.

Legs run in one process, one after another, freeing their arrays between
legs.  The reference publishes no numbers (BASELINE.md), so there is no
baseline ratio.

Env knobs: BLZ_BENCH_LOGN (MSM, default 24), BLZ_BENCH_CURVE (bls12_381),
BLZ_BENCH_ITERS (3), BLZ_BENCH_NTT_LOGN (24), BLZ_BENCH_POSEIDON_LOGL
(15; leaves = 2^15 = 8^5), BLZ_BENCH_ONLY (csv of
msm,ntt,poseidon,pipeline).  The MSM leg traces one extra call into a
temporary directory and adds its device-time split (`bench/trace.py`) to
its record.  The pipeline leg feeds the first quarter of the NTT's
spectrum to the MSM.
"""
import gc
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def _best(fn, iters: int) -> float:
    """Best wall time of `iters` calls of fn (each ends in a barrier)."""
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def bench_msm(logn: int, curve_name: str, iters: int) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from blaze_tpu.bench.trace import device_split
    from blaze_tpu.curves import CURVES, Curve
    from blaze_tpu.msm import MSM
    from blaze_tpu.oracle import (
        class_msm_oracle, random_scalar_limbs, tiled_msm_instance,
    )

    n = 1 << logn
    spec = CURVES[curve_name]
    curve = Curve(spec)
    msm = MSM(curve)
    # points tiled with period 256 (the reference's own large-size trick,
    # tests/msm/mod.rs:23-31), scalars all distinct and random
    upts, _, _, dbg = tiled_msm_instance(spec, 256, seed=123)
    scalars = random_scalar_limbs(spec, n, seed=123)
    pts = curve.fq.jit_op("to_mont")(jnp.asarray(upts[np.arange(n) % 256]))
    scal = jnp.asarray(scalars)
    jax.block_until_ready((pts, scal))

    t0 = time.perf_counter()
    out = jax.block_until_ready(msm(pts, scal))      # warmup / compile
    first_s = time.perf_counter() - t0
    aff = curve.to_affine(out[None])[0]
    got = (curve.fq.to_int(aff[0]), curve.fq.to_int(aff[1]))
    if got != class_msm_oracle(spec, dbg["points"], scalars):
        raise AssertionError("MSM result diverges from the oracle")
    best = _best(lambda: jax.block_until_ready(msm(pts, scal)), iters)

    rec = {
        "metric": f"{curve_name}_msm_2^{logn}",
        "value": n / best,
        "unit": "points/sec",
        "ms": best * 1e3,
        "oracle": "exact",
        "scalars": "distinct random",
        "first_call_s": first_s,
    }
    # field muls of the dominant cost: one mixed add (11 muls) per point
    # per window in the bucket scan
    c = min(msm.config.window_bits, 16)
    rec["field_muls_per_sec"] = -(-spec.fr.bits // c) * n * 11 / best
    logdir = tempfile.mkdtemp(prefix="blz_trace_")
    try:
        jax.profiler.start_trace(logdir)
        jax.block_until_ready(msm(pts, scal))
        jax.profiler.stop_trace()
        rec["device_split_s"] = device_split(logdir)
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    return rec


def bench_ntt(logn: int, iters: int) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from blaze_tpu.fields import FIELDS
    from blaze_tpu.ntt import make_ntt

    spec = FIELDS["bls12_381_fr"]
    n = 1 << logn
    plan = make_ntt(spec, logn)
    rng = np.random.default_rng(7)
    x = rng.integers(0, 1 << 16, size=(n, spec.nlimbs), dtype=np.uint32)
    x[:, -1] &= 0x3FFF  # < p
    xdev = jnp.asarray(x)
    back = jax.block_until_ready(plan.intt(plan.ntt(xdev)))  # warmup
    if not np.array_equal(np.asarray(back), x):
        raise AssertionError("NTT round trip diverges")
    del back
    best = _best(lambda: jax.block_until_ready(plan.ntt(xdev)), iters)
    return {
        "metric": f"ntt_2^{logn}",
        "value": n / best,
        "unit": "elems/sec",
        "ms": best * 1e3,
    }


def bench_poseidon(logl: int, iters: int) -> dict:
    """Merkle-tree build at 2^logl leaves, TreeC mode, through the client
    lifecycle (the reference streams elements and drains records through
    this surface, integration_poseidon.rs:151-155 + poseidon_api.rs:128-145).
    Timed region: start_process -> wait_result; logl must be a multiple of
    3 (8-ary base layer, utils.rs:12-14)."""
    if logl % 3:
        raise ValueError(f"8-ary tree base must be a power of 8 (logl={logl})")
    import numpy as np

    from blaze_tpu.fields import FIELDS
    from blaze_tpu.hash.tree import LEAF_ARITY, TreeMode, num_tree_nodes
    from blaze_tpu.runtime.clients import (
        PoseidonClient,
        PoseidonInitializeParameters,
    )

    spec = FIELDS["bls12_381_fr"]
    nleaves = 1 << logl
    rng = np.random.default_rng(9)
    elems = rng.integers(
        0, 1 << 16, size=(nleaves * LEAF_ARITY, spec.nlimbs), dtype=np.uint32)
    elems[..., -1] &= 0x3FFF
    height = 1 + logl // 3

    cl = PoseidonClient(spec)
    cl.initialize(PoseidonInitializeParameters(
        tree_height=height, tree_mode=TreeMode.TREE_C))
    cl.set_data(elems)

    def run():
        cl.start_process()
        cl.wait_result()

    run()                                    # warmup / compile
    best = _best(run, iters)
    if len(cl.result_raw()) != 64 * num_tree_nodes(height):
        raise AssertionError("wrong record count")
    return {
        "metric": f"poseidon_2^{logl}_leaves",
        "value": nleaves / best,
        "unit": "leaves/sec",
        "ms": best * 1e3,
        "via": "client",
    }


def bench_pipeline(ntt_logn: int, msm_logn: int, iters: int) -> dict:
    """NTT 2^ntt_logn feeding a BLS12-381 MSM 2^msm_logn as scalars, 2-deep
    across primitives (blaze_tpu/pipeline.py), checked against the
    closed-form geometric MSM (delta coefficients -> scalars are w^i)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from blaze_tpu.curves import CURVES, Curve
    from blaze_tpu.fields.spec import int_to_limbs
    from blaze_tpu.oracle import tiled_msm_instance
    from blaze_tpu.pipeline import ProofPipeline, geometric_msm_oracle

    spec = CURVES["bls12_381"]
    curve = Curve(spec)
    fr = spec.fr
    n_msm = 1 << msm_logn
    upts, _, _, dbg = tiled_msm_instance(spec, 256, seed=123)
    pts = curve.fq.jit_op("to_mont")(
        jnp.asarray(upts[np.arange(n_msm) % 256]))
    pipe = ProofPipeline(curve, ntt_logn, msm_logn)
    one = jnp.asarray(int_to_limbs(fr.r % fr.p, fr.nlimbs))

    @jax.jit
    def make_delta():
        return jnp.zeros((1 << ntt_logn, fr.nlimbs), jnp.uint32).at[1].set(one)

    from chip_smoke import warm_batch_s

    nb = max(iters, 4) + 2
    t0 = time.perf_counter()
    stamps, outs = [], []
    for out in pipe.run_batches((make_delta() for _ in range(nb)), pts):
        stamps.append(time.perf_counter() - t0)
        outs.append(out)
    per_batch = warm_batch_s(stamps)
    expected = geometric_msm_oracle(
        spec, 256, n_msm, fr.root_of_unity(ntt_logn), dbg["points"])
    aff = curve.to_affine(outs[-1][None])[0]
    if (curve.fq.to_int(aff[0]), curve.fq.to_int(aff[1])) != expected:
        raise AssertionError("pipeline result diverges from oracle")
    return {
        "metric": f"pipeline_ntt2^{ntt_logn}_msm2^{msm_logn}",
        "value": 1.0 / per_batch,
        "unit": "proofs/sec",
        "ms": per_batch * 1e3,
        "oracle": "exact",
    }


def main():
    sys.path.insert(0, HERE)
    import jax

    from blaze_tpu.utils.cache import parallel_gpu_compile, setup_compile_cache

    parallel_gpu_compile()
    setup_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU; JAX found {dev.platform}", file=sys.stderr)
        return 1
    from chip_smoke import card_line

    stamp = {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card_line().splitlines()[0],
    }
    env = os.environ.get
    logn = int(env("BLZ_BENCH_LOGN", "24"))
    curve_name = env("BLZ_BENCH_CURVE", "bls12_381")
    iters = int(env("BLZ_BENCH_ITERS", "3"))
    ntt_logn = int(env("BLZ_BENCH_NTT_LOGN", "24"))
    pos_logl = int(env("BLZ_BENCH_POSEIDON_LOGL", "15"))
    only = set(env("BLZ_BENCH_ONLY", "msm,ntt,poseidon,pipeline").split(","))

    recs, errors = [], {}
    for name, runner in (
        ("msm", lambda: bench_msm(logn, curve_name, iters)),
        ("ntt", lambda: bench_ntt(ntt_logn, iters)),
        ("poseidon", lambda: bench_poseidon(pos_logl, iters)),
        ("pipeline", lambda: bench_pipeline(ntt_logn, ntt_logn - 2, iters)),
    ):
        if name not in only:
            continue
        try:
            rec = runner()
        except Exception as e:  # report every leg, then fail the run
            errors[name] = f"{type(e).__name__}: {e}"
            continue
        finally:
            gc.collect()
        # the process's peak so far: legs run in order, so a leg whose
        # own peak is lower repeats the earlier value
        rec["peak_bytes_in_use"] = (dev.memory_stats() or {}).get(
            "peak_bytes_in_use")
        recs.append(rec)

    out = dict(recs[0]) if recs else {"metric": "error", "value": 0}
    out["extra"] = {r["metric"]: {k: v for k, v in r.items() if k != "metric"}
                    for r in recs[1:]}
    out.update(stamp)
    if errors:
        out["errors"] = errors
    print(json.dumps(out))
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
