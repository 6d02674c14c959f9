#!/usr/bin/env python
"""On-card smoke test: the MSM, NTT and Poseidon clients and the NTT -> MSM
pipeline at full width on one GPU, each checked bit-exact against its
oracle.

    python chip_smoke.py            # one card: every default phase
    python chip_smoke.py --multi    # four cards: the mesh paths only
    python chip_smoke.py --ntt27    # one card: the NTT client at 2^27 only

Phases (default run):
  0. device: platform must be `gpu`; card name and power limit, JAX
     version, compile-cache directory, native codec;
  1. Poseidon TreeC, 2^15 leaves (64 sampled leaf hashes vs the oracle)
     and the reference's height-4 tree (585 nodes, all vs the oracle);
  2. NTT bls12_381_fr 2^24 through NTTClient: dense byte round trip
     (forward then inverse client) and a sparse input's spectrum at
     sampled indices vs a host evaluation;
  3. MSM BLS12-381 2^24 through MSMClient on wire bytes, 2^24 distinct
     random scalars, points tiled with period 256, vs the coefficient-sum
     oracle; then its first 2^22 through the streaming lifecycle;
  4. ProofPipeline.run_batches, NTT 2^24 -> MSM 2^22, 6 batches of a delta
     input (scalars are w^i) vs the geometric oracle.

Every comparison is exact (uint32 limb arithmetic, no float products).
The last stdout line is one JSON object; any failed check exits non-zero
before it.  Without a GPU the script exits non-zero at phase 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
T0 = time.perf_counter()


def say(msg: str) -> None:
    """One progress line, stamped with seconds since the script started
    (a run cut at its time limit still shows how far it got)."""
    print(f"  [{time.perf_counter() - T0:7.1f} s] {msg}", flush=True)


def card_line() -> str:
    """nvidia-smi's name and power limit of every card (a child process
    that stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


class Meter:
    """Wall time and XLA backend compile time and count of one phase
    step (compile events come from `jax.monitoring`)."""

    def __init__(self):
        import jax

        self.compile_s = 0.0
        self.compiles = 0

        def on_event(event, duration, **_):
            if event == "/jax/core/compile/backend_compile_duration":
                self.compile_s += duration
                self.compiles += 1

        jax.monitoring.register_event_duration_secs_listener(on_event)

    def run(self, fn):
        """(result, wall_s, compile_s, compiles) of fn()."""
        c0, k0 = self.compile_s, self.compiles
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
        return out, wall, self.compile_s - c0, self.compiles - k0


def peak_bytes() -> int | None:
    """Device peak bytes in use so far (cumulative over the process)."""
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def report(phase: str, card: str, **fields) -> None:
    fields["peak_bytes_in_use"] = peak_bytes()
    fields["card"] = card
    print(f"[{phase}] " + json.dumps(fields, default=str), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)
    say(f"ok: {what}")


def warm_batch_s(stamps) -> float:
    """Seconds per batch of a 2-deep pipeline from the times its batches
    were yielded.  The first yield carries the compile and the last is the
    drain (it follows the one before it by a fraction of a batch), so the
    window from the first yield to the next-to-last holds len - 2 steady
    batches."""
    if len(stamps) < 3:
        raise ValueError("a warm window needs at least 3 batches")
    return (stamps[-2] - stamps[0]) / (len(stamps) - 2)


def _random_field_limbs(spec, shape, rng) -> np.ndarray:
    """uint32 limbs of random values < 2^(bits-1) < p."""
    out = rng.integers(0, 1 << 16, size=(*shape, spec.nlimbs), dtype=np.uint32)
    top = spec.bits - 1 - 16 * (spec.nlimbs - 1)
    out[..., -1] &= (1 << top) - 1
    return out


def _affine_of(raw: bytes, spec):
    """z||y||x result bytes -> normalized affine (x, y) ints (None = O)."""
    from blaze_tpu.curves import decode_projective_result
    from blaze_tpu.fields import limbs_to_int

    x, y, z = (limbs_to_int(v) for v in decode_projective_result(raw, spec))
    p = spec.fq.p
    if z % p == 0:
        return None
    zi = pow(z, -1, p)
    return (x * zi % p, y * zi % p)


# ------------------------------------------------------------------ phases
def phase_msm(meter: Meter, card: str = "", curve: str = "bls12_381",
              logn: int = 24, stream_logn: int = 22, seed: int = SEED,
              config=None) -> None:
    """MSMClient on wire bytes: 2^logn resident, then the first
    2^stream_logn through the streaming lifecycle."""
    from blaze_tpu.curves import CURVES, encode_affine_points, encode_scalars
    from blaze_tpu.oracle import (
        class_msm_oracle, random_scalar_limbs, tiled_msm_instance,
    )
    from blaze_tpu.runtime import MSMClient, MSMInit, MSMInput, MSMParams

    spec = CURVES[curve]
    n, m = 1 << logn, 1 << stream_logn
    pb, sb = spec.point_bytes, spec.scalar_bytes
    upts, _, _, dbg = tiled_msm_instance(spec, 256, seed=seed)
    ucls = min(n, 256)
    point_wire = np.tile(
        np.frombuffer(encode_affine_points(upts[:ucls], spec), np.uint8)
        .reshape(ucls, pb), (n // ucls, 1),
    ).tobytes()
    scalars = random_scalar_limbs(spec, n, seed=seed)
    scalar_wire = encode_scalars(scalars, spec)
    t0 = time.perf_counter()
    expected = class_msm_oracle(spec, dbg["points"][:ucls], scalars)
    host_s = time.perf_counter() - t0

    client = MSMClient(MSMInit(curve=curve), config=config)
    client.initialize(MSMParams(nof_elements=n))
    _, set_s, _, _ = meter.run(lambda: client.set_data(
        MSMInput(scalars=scalar_wire, points=point_wire)))

    def once():
        client.start_process()
        client.wait_result()
        return client.result()

    first, first_s, comp_s, ncomp = meter.run(once)
    warm, warm_s, _, warm_comp = meter.run(once)
    check(_affine_of(first.result, spec) == expected,
          f"MSM {curve} 2^{logn} resident == coefficient-sum oracle")
    check(warm.result == first.result, "warm MSM repeats the first result")
    report("msm", card, curve=curve, n=n, distinct_scalars=n,
           set_data_s=set_s, first_s=first_s, compile_s=comp_s,
           compiles=ncomp, warm_s=warm_s, warm_compiles=warm_comp,
           points_per_s=n / warm_s, oracle_host_s=host_s,
           timings=dataclasses.asdict(client._timings))
    del client
    gc.collect()

    # streaming lifecycle: start_process first, then one set_data per
    # engine chunk (the reference's own call order)
    prefix = class_msm_oracle(spec, dbg["points"][:ucls], scalars[:m])
    stream = MSMClient(MSMInit(curve=curve), config=config)
    chunk = min(m, 1 << stream.engine.config.chunk_log2)

    def streamed():
        stream.initialize(MSMParams(nof_elements=m))
        stream.start_process()
        for lo in range(0, m, chunk):
            stream.set_data(MSMInput(
                scalars=scalar_wire[lo * sb:(lo + chunk) * sb],
                points=point_wire[lo * pb:(lo + chunk) * pb],
            ))
        return stream.result()

    res, wall, comp_s, ncomp = meter.run(streamed)
    check(_affine_of(res.result, spec) == prefix,
          f"MSM {curve} 2^{stream_logn} streamed in {m // chunk} chunks "
          "== coefficient-sum oracle")
    report("msm_stream", card, curve=curve, n=m, chunk=chunk, wall_s=wall,
           compile_s=comp_s, compiles=ncomp, points_per_s=m / wall,
           timings=dataclasses.asdict(stream._timings))


def phase_ntt(meter: Meter, card: str = "", field: str = "bls12_381_fr",
              logn: int = 24, nsample: int = 4096, nnz: int = 64,
              seed: int = SEED) -> None:
    """NTTClient forward + inverse on wire bytes, both buffer slots."""
    from blaze_tpu.fields import FIELDS, bytes_to_limbs, limbs_to_bytes
    from blaze_tpu.fields.spec import limbs_to_int
    from blaze_tpu.runtime import NTTClient, NTTInit, NTTInput

    spec = FIELDS[field]
    n, p = 1 << logn, spec.p
    rng = np.random.default_rng(seed)
    dense = limbs_to_bytes(_random_field_limbs(spec, (n,), rng), spec)
    pos = rng.choice(n, size=min(nnz, n), replace=False)
    vals = _random_field_limbs(spec, (pos.size,), rng)
    sparse_limbs = np.zeros((n, spec.nlimbs), np.uint32)
    sparse_limbs[pos] = vals
    sparse = limbs_to_bytes(sparse_limbs, spec)

    fwd = NTTClient(NTTInit(field=field, logn=logn))
    inv = NTTClient(NTTInit(field=field, logn=logn), inverse=True)
    fwd.set_data(NTTInput(data=dense, buf_host=0))
    fwd.set_data(NTTInput(data=sparse, buf_host=1))

    def forward_both():
        fwd.start_process(0)
        fwd.start_process(1)
        fwd.wait_result()

    _, first_s, comp_s, ncomp = meter.run(forward_both)
    _, warm_s, _, warm_comp = meter.run(forward_both)
    spec_dense, spec_sparse = fwd.result(0), fwd.result(1)

    inv.set_data(NTTInput(data=spec_dense, buf_host=0))

    def inverse():
        inv.start_process(0)
        inv.wait_result(0)
        return inv.result(0)

    back, inv_s, inv_comp_s, _ = meter.run(inverse)
    check(back == dense, f"NTT {field} 2^{logn} dense byte round trip exact")

    w = spec.root_of_unity(logn)
    ks = np.unique(np.concatenate(
        [[0, 1, n - 1], rng.integers(0, n, size=nsample)]))[:nsample]
    coeffs = [(pow(w, int(j), p), limbs_to_int(v)) for j, v in zip(pos, vals)]
    want = [sum(a * pow(wj, int(k), p) for wj, a in coeffs) % p for k in ks]
    got_limbs = bytes_to_limbs(spec_sparse, spec)[ks]
    check([limbs_to_int(r) for r in got_limbs] == want,
          f"NTT {field} 2^{logn} sparse spectrum == host evaluation at "
          f"{len(ks)} indices")
    report("ntt", card, field=field, n=n, first_two_s=first_s,
           compile_s=comp_s, compiles=ncomp, warm_two_s=warm_s,
           warm_compiles=warm_comp, elems_per_s=2 * n / warm_s,
           inverse_s=inv_s, inverse_compile_s=inv_comp_s,
           timings=dataclasses.asdict(fwd._timings))


def phase_poseidon(meter: Meter, card: str = "", field: str = "bls12_381_fr",
                   height: int = 6, nsample: int = 64, full_height: int = 4,
                   seed: int = SEED) -> None:
    """PoseidonClient TreeC at height `height` (sampled leaves) and at
    `full_height` (every node) vs the pure-python oracle."""
    from blaze_tpu.fields import FIELDS, limbs_to_bytes
    from blaze_tpu.fields.spec import limbs_to_int
    from blaze_tpu.hash import (
        LEAF_ARITY, base_layer_size, generate_params, num_tree_nodes,
    )
    from blaze_tpu.oracle.poseidon_ref import merkle_tree_ref, poseidon_hash_ref
    from blaze_tpu.runtime import PoseidonClient, PoseidonInitializeParameters

    spec = FIELDS[field]
    rng = np.random.default_rng(seed)
    leaf_params = generate_params(spec, LEAF_ARITY + 1)
    node_params = generate_params(spec, 9)

    def build(h):
        nleaves = base_layer_size(h)
        cols = _random_field_limbs(spec, (nleaves, LEAF_ARITY), rng)
        client = PoseidonClient(field)
        client.initialize(PoseidonInitializeParameters(tree_height=h))
        client.set_data(limbs_to_bytes(cols, spec))

        def once():
            client.start_process()
            client.wait_result()

        _, first_s, comp_s, ncomp = meter.run(once)
        _, warm_s, _, warm_comp = meter.run(once)
        raw, drain_s, _, _ = meter.run(client.result_raw)
        check(len(raw) == 64 * num_tree_nodes(h),
              f"Poseidon height {h}: {num_tree_nodes(h)} records")
        recs = np.frombuffer(raw, np.uint8).reshape(-1, 64)
        hashes = [int.from_bytes(r[:32].tobytes(), "little") for r in recs]
        timing = dict(height=h, leaves=nleaves, first_s=first_s,
                      compile_s=comp_s, compiles=ncomp, warm_s=warm_s,
                      warm_compiles=warm_comp, drain_s=drain_s,
                      leaves_per_s=nleaves / warm_s,
                      timings=dataclasses.asdict(client._timings))
        return cols, hashes, timing

    cols, hashes, timing = build(height)
    idx = rng.choice(len(cols), size=min(nsample, len(cols)), replace=False)
    want = [poseidon_hash_ref(leaf_params,
                              [limbs_to_int(e) for e in cols[i]])
            for i in idx]
    check([hashes[i] for i in idx] == want,
          f"Poseidon height {height}: {len(idx)} sampled leaf hashes == oracle")
    report("poseidon", card, field=field, **timing)

    cols, hashes, timing = build(full_height)
    layers = merkle_tree_ref(
        leaf_params, node_params,
        [[limbs_to_int(e) for e in col] for col in cols], full_height,
    )
    check(hashes == [h for layer in layers for h in layer],
          f"Poseidon height {full_height}: all {len(hashes)} nodes == oracle")
    report("poseidon_full", card, field=field, **timing)


def phase_pipeline(meter: Meter, card: str = "", curve: str = "bls12_381",
                   ntt_logn: int = 24, msm_logn: int = 22, nbatches: int = 6,
                   seed: int = SEED, config=None) -> None:
    """ProofPipeline.run_batches over `nbatches` delta inputs."""
    import jax
    import jax.numpy as jnp

    from blaze_tpu.curves import CURVES, Curve
    from blaze_tpu.fields.spec import int_to_limbs
    from blaze_tpu.oracle import tiled_msm_instance
    from blaze_tpu.pipeline import ProofPipeline, geometric_msm_oracle

    spec = CURVES[curve]
    cv = Curve(spec)
    fr, L = spec.fr, spec.fr.nlimbs
    m = 1 << msm_logn
    ucls = min(m, 256)
    upts, _, _, dbg = tiled_msm_instance(spec, 256, seed=seed)
    pts = cv.fq.jit_op("to_mont")(jnp.asarray(upts[:ucls][np.arange(m) % ucls]))
    one_mont = jnp.asarray(int_to_limbs(fr.r % fr.p, L))

    @jax.jit
    def delta():                   # Montgomery delta at index 1
        return jnp.zeros((1 << ntt_logn, L), jnp.uint32).at[1].set(one_mont)

    pipe = ProofPipeline(cv, ntt_logn, msm_logn, config=config)
    stamps, outs = [], []

    def run():
        t0 = time.perf_counter()
        for out in pipe.run_batches((delta() for _ in range(nbatches)), pts):
            stamps.append(time.perf_counter() - t0)
            outs.append(out)

    _, wall, comp_s, ncomp = meter.run(run)
    w = fr.root_of_unity(ntt_logn)
    expected = geometric_msm_oracle(spec, ucls, m, w, dbg["points"][:ucls])
    got = [_affine_of_mont(cv, o) for o in outs]
    check(len(got) == nbatches and all(g == expected for g in got),
          f"pipeline NTT 2^{ntt_logn} -> MSM 2^{msm_logn}: {nbatches} "
          "batches == geometric oracle")
    report("pipeline", card, curve=curve, ntt_n=1 << ntt_logn, msm_n=m,
           batches=nbatches, wall_s=wall, compile_s=comp_s, compiles=ncomp,
           batch_stamps_s=stamps, warm_batch_s=warm_batch_s(stamps))


def _affine_of_mont(cv, out):
    """(3, L) Montgomery projective device point -> affine (x, y) ints."""
    aff = cv.to_affine(out[None])[0]
    return (cv.fq.to_int(aff[0]), cv.fq.to_int(aff[1]))


def phase_multi(meter: Meter, devices, card: str = "",
                curve: str = "bls12_381", msm_logn: int = 24,
                ntt_logn: int = 24, pipe_classes: int = 257,
                window_bits: int | None = None, seed: int = SEED) -> None:
    """DistributedMSM (dp), DistributedNTT (sp) and ProofPipeline.run_dist
    over a 1-D mesh of `devices`.

    The dp MSM runs the phase-3 instance (same seed, so the same points
    and scalars) and is held to the coefficient-sum oracle that the
    default run holds the one-device MSM to.  The sp NTT is compared with
    the one-device plan.  The pipeline feeds the whole 2^ntt_logn spectrum
    of a delta to a 2^ntt_logn dp MSM over points of period `pipe_classes`,
    which must not divide 2^ntt_logn (a full sum of roots of unity would
    make the oracle the identity).  The dp MSM and sp NTT checked first
    are the pipeline's own, so each program compiles once."""
    import jax
    import jax.numpy as jnp

    from blaze_tpu.curves import CURVES, Curve
    from blaze_tpu.dist import make_mesh
    from blaze_tpu.fields import Field
    from blaze_tpu.fields.spec import int_to_limbs
    from blaze_tpu.ntt import make_ntt
    from blaze_tpu.oracle import (
        class_msm_oracle, random_scalar_limbs, tiled_msm_instance,
    )
    from blaze_tpu.pipeline import ProofPipeline, geometric_msm_oracle

    spec = CURVES[curve]
    cv = Curve(spec)
    fr = spec.fr
    nd = len(devices)
    mesh = make_mesh({"dp": nd}, devices=devices)
    shard = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("dp"))
    on = lambda a: sorted(str(s.device) for s in a.addressable_shards)
    to_mont = cv.fq.jit_op("to_mont")
    pipe = ProofPipeline(cv, ntt_logn, ntt_logn, mesh=mesh,
                         msm_axis="dp", ntt_axis="dp")

    # --- data-parallel MSM, the phase-3 instance
    n = 1 << msm_logn
    ucls = min(n, 256)
    upts, _, _, dbg = tiled_msm_instance(spec, 256, seed=seed)
    scalars = random_scalar_limbs(spec, n, seed=seed)
    expected = class_msm_oracle(spec, dbg["points"][:ucls], scalars)
    pts = to_mont(jax.device_put(upts[:ucls][np.arange(n) % ucls], shard))
    scal = jax.device_put(scalars, shard)
    say(f"msm points on {on(pts)}; dp MSM starts")
    out, first_s, comp_s, ncomp = meter.run(
        lambda: jax.block_until_ready(
            pipe.dmsm(pts, scal, window_bits=window_bits)))
    say(f"msm result on {on(out)}")
    check(len(set(on(out))) == nd, f"dp MSM result lives on all {nd} devices")
    check(_affine_of_mont(cv, out) == expected,
          f"dp MSM {curve} 2^{msm_logn} over {nd} devices == the "
          "coefficient-sum oracle the one-device MSM matches")
    report("multi_msm", card, devices=nd, n=n, first_s=first_s,
           compile_s=comp_s, compiles=ncomp)
    del pts, scal, out
    gc.collect()

    # --- sequence-parallel NTT vs the one-device plan
    nn = 1 << ntt_logn
    rng = np.random.default_rng(seed)
    x = Field(fr).jit_op("to_mont")(
        jnp.asarray(_random_field_limbs(fr, (nn,), rng)))
    dntt = pipe.dntt
    say("sp NTT starts")
    yk, first_s, comp_s, ncomp = meter.run(
        lambda: jax.block_until_ready(dntt.ntt(x)))
    say(f"ntt spectrum on {on(yk)}")
    check(len(set(on(yk))) == nd, f"sp NTT output lives on all {nd} devices")
    ynat = np.asarray(dntt.spectral_to_natural(yk))
    say("one-device NTT starts")
    with jax.default_device(devices[0]):
        ref = np.asarray(make_ntt(fr, ntt_logn).ntt(x))
    check(np.array_equal(ynat, ref),
          f"sp NTT {fr.name} 2^{ntt_logn} over {nd} devices == one-device "
          "plan")
    report("multi_ntt", card, devices=nd, n=nn, first_s=first_s,
           compile_s=comp_s, compiles=ncomp)
    del x, yk, ynat, ref
    gc.collect()

    # --- NTT -> MSM on the mesh: delta input, scalars are w^i
    ppts, _, _, pdbg = tiled_msm_instance(spec, pipe_classes, seed=seed + 1)
    coeffs = np.zeros((nn, fr.nlimbs), np.uint32)
    coeffs[1] = int_to_limbs(fr.r % fr.p, fr.nlimbs)      # Montgomery 1
    pts = to_mont(jax.device_put(ppts[np.arange(nn) % pipe_classes], shard))
    say("run_dist starts")
    pout, wall, comp_s, ncomp = meter.run(lambda: jax.block_until_ready(
        pipe.run_dist(jnp.asarray(coeffs), pts, window_bits=window_bits)))
    say(f"pipeline result on {on(pout)}")
    want = geometric_msm_oracle(spec, pipe_classes, nn,
                                fr.root_of_unity(ntt_logn), pdbg["points"])
    check(_affine_of_mont(cv, pout) == want,
          f"run_dist NTT 2^{ntt_logn} -> MSM 2^{ntt_logn} over {nd} devices "
          "== geometric oracle")
    report("multi_pipeline", card, devices=nd, ntt_n=nn, msm_n=nn,
           wall_s=wall, compile_s=comp_s, compiles=ncomp)


def ensure_native() -> str:
    """Build the native codec if it is missing; say which codec runs."""
    from blaze_tpu.native import codec

    so = os.path.join(HERE, "blaze_tpu", "native", "libblaze_codec.so")
    if not os.path.exists(so):
        proc = subprocess.run(["make", "-C", os.path.join(HERE, "csrc")],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            return "numpy fallback (build failed: " + proc.stderr[-300:] + ")"
    return "native" if codec.have_native() else "numpy fallback"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="four cards: dp MSM, sp NTT, run_dist only")
    ap.add_argument("--ntt27", action="store_true",
                    help="one card: the NTT client at 2^27 only")
    ap.add_argument("--seed", type=int, default=SEED)
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    import jax

    from blaze_tpu.utils.cache import parallel_gpu_compile, setup_compile_cache

    parallel_gpu_compile()
    cache = setup_compile_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {devs[0].platform}",
              file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    print(f"[device] kind={devs[0].device_kind!r} count={len(devs)} "
          f"jax={jax.__version__} cache={cache} codec={ensure_native()} "
          "float products on the path: none (uint32 limb arithmetic)",
          flush=True)
    card = card.splitlines()[0]
    meter = Meter()
    t0 = time.perf_counter()
    if args.multi:
        if len(devs) < 4:
            raise RuntimeError(f"--multi needs 4 GPUs, have {len(devs)}")
        phase_multi(meter, devs[:4], card, seed=args.seed)
    elif args.ntt27:
        phase_ntt(meter, card, logn=27, nsample=256, seed=args.seed)
    else:
        phase_poseidon(meter, card, seed=args.seed)
        phase_ntt(meter, card, seed=args.seed)
        phase_msm(meter, card, seed=args.seed)
        phase_pipeline(meter, card, seed=args.seed)
    print(f"[total] wall_s={time.perf_counter() - t0:.1f} "
          f"compile_s={meter.compile_s:.1f} compiles={meter.compiles}",
          flush=True)
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
