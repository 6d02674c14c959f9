"""Streaming set_data lifecycles.

MSM: the reference queues the task FIRST and then streams 2048-element
scalar/point chunks by DMA while the engine consumes them
(`/root/reference/src/ingo_msm/msm_api.rs:113-217`; call order in §3.1 of
the survey: initialize -> start_process -> set_data).  The client mirrors
that: start_process with no staged operands opens a streaming task, each
set_data chunk dispatches its per-window partials immediately (async — the
transfer of chunk k+1 overlaps the compute of chunk k), and wait_result
folds the accumulated windows.
"""
import numpy as np
import pytest

from blaze_tpu.curves import (
    CURVES,
    decode_projective_result,
    encode_affine_points,
    encode_scalars,
)
from blaze_tpu.fields import limbs_to_int
from blaze_tpu.oracle import ECOracle, random_msm_instance
from blaze_tpu.runtime import MSMClient, MSMInit, MSMInput, MSMParams
from blaze_tpu.utils import InvalidPrimitiveParam, NotReady

CURVE = "bn254"


def wire_instance(n, seed):
    spec = CURVES[CURVE]
    points, scalars, expected, _ = random_msm_instance(spec, n, seed)
    return (
        encode_affine_points(points, spec),
        encode_scalars(scalars, spec),
        expected,
    )


def check(raw, expected):
    spec = CURVES[CURVE]
    proj = decode_projective_result(raw, spec)
    x, y, z = (limbs_to_int(proj[i]) for i in range(3))
    p = spec.fq.p
    zinv = pow(z, -1, p)
    pt = (x * zinv % p, y * zinv % p)
    assert ECOracle(spec).on_curve(pt)
    assert pt == expected


def test_msm_streaming_chunks(monkeypatch):
    """Reference call order, 4 chunks; oracle-exact; set_data must stay
    async (no device sync while feeding — that IS the overlap: compute on
    chunk k proceeds while chunk k+1 transfers)."""
    import blaze_tpu.runtime.clients as C

    n, nchunks = 64, 4
    step = n // nchunks
    spec = CURVES[CURVE]
    praw, sraw, expected = wire_instance(n, seed=60)
    pb, sb = spec.point_bytes, spec.scalar_bytes

    client = MSMClient(MSMInit(curve=CURVE))
    client.initialize(MSMParams(nof_elements=n))
    client.start_process()                       # opens the streaming task
    assert not client.is_msm_engine_ready()
    assert client.pending_tasks == 1

    real_sync = C.jax.block_until_ready
    syncs = []

    def counting_sync(x):
        syncs.append(1)
        return real_sync(x)

    monkeypatch.setattr(C.jax, "block_until_ready", counting_sync)

    with pytest.raises(NotReady):
        client.wait_result()                     # nothing fed yet

    for i in range(nchunks):
        client.set_data(MSMInput(
            scalars=sraw[i * step * sb:(i + 1) * step * sb],
            points=praw[i * step * pb:(i + 1) * step * pb],
        ))
        assert client.get_api()["streamed_elements"] == (i + 1) * step
    assert not syncs                             # feeding never blocked

    with pytest.raises(InvalidPrimitiveParam):   # overflow past the task size
        client.set_data(MSMInput(
            scalars=sraw[:sb], points=praw[:pb]
        ))

    client.wait_result()
    assert syncs                                 # the fold synced
    res = client.result()
    assert res is not None and res.label == 0
    check(res.result, expected)
    assert client.is_msm_engine_ready()


def test_msm_streaming_scalars_only_from_cache():
    """Mode-3 streaming: points resident under a key (HBM cache analog),
    scalars streamed in chunks and matched against the cached slice."""
    n, step = 64, 16
    spec = CURVES[CURVE]
    praw, sraw, expected = wire_instance(n, seed=61)
    sb = spec.scalar_bytes

    client = MSMClient(MSMInit(curve=CURVE, mem_type="hbm"))
    client.load_data_to_hbm("bank0", praw)
    client.initialize(MSMParams(nof_elements=n, hbm_point_addr="bank0"))
    client.start_process()
    for i in range(0, n, step):
        client.set_data(MSMInput(scalars=sraw[i * sb:(i + step) * sb]))
    res = client.result()
    check(res.result, expected)


def test_msm_streaming_random_distinct_scalars():
    """Streamed chunks of DISTINCT random scalars over points tiled with
    period 8, vs the coefficient-sum oracle."""
    from blaze_tpu.oracle import (
        class_msm_oracle, random_scalar_limbs, tiled_msm_instance,
    )

    spec = CURVES[CURVE]
    n, step, ncls = 64, 16, 8
    upts, _, _, dbg = tiled_msm_instance(spec, ncls, seed=63)
    scalars = random_scalar_limbs(spec, n, seed=64)
    praw = encode_affine_points(upts[np.arange(n) % ncls], spec)
    sraw = encode_scalars(scalars, spec)
    pb, sb = spec.point_bytes, spec.scalar_bytes

    client = MSMClient(MSMInit(curve=CURVE))
    client.initialize(MSMParams(nof_elements=n))
    client.start_process()
    for i in range(0, n, step):
        client.set_data(MSMInput(scalars=sraw[i * sb:(i + step) * sb],
                                 points=praw[i * pb:(i + step) * pb]))
    check(client.result().result,
          class_msm_oracle(spec, dbg["points"], scalars))


def test_msm_streaming_precompute():
    """Streamed chunks with precompute_factor > 1: wire order is
    point-major (each base followed by its multiples,
    tests/msm/mod.rs:360-380), per chunk."""
    spec = CURVES[CURVE]
    from blaze_tpu.fields import int_to_limbs
    from blaze_tpu.msm import shift_bits_for

    oracle = ECOracle(spec)
    n, factor, step = 8, 4, 4
    points, scalars, expected, _ = random_msm_instance(spec, n, seed=62)
    shift = shift_bits_for(spec.fr.bits, factor)
    expanded = []
    for (x, y) in (tuple(map(limbs_to_int, p)) for p in points):
        cur = (x, y)
        expanded.append(cur)
        for _ in range(factor - 1):
            cur = oracle.mul(cur, 1 << shift)
            expanded.append(cur)
    arr = np.stack(
        [
            np.stack([int_to_limbs(x, spec.fq.nlimbs),
                      int_to_limbs(y, spec.fq.nlimbs)])
            for x, y in expanded
        ]
    )
    praw = encode_affine_points(arr, spec)
    sraw = encode_scalars(scalars, spec)
    pb, sb = spec.point_bytes, spec.scalar_bytes

    client = MSMClient(MSMInit(curve=CURVE, precompute_factor=factor))
    client.initialize(MSMParams(nof_elements=n))
    client.start_process()
    for i in range(0, n, step):
        client.set_data(MSMInput(
            scalars=sraw[i * sb:(i + step) * sb],
            points=praw[i * factor * pb:(i + step) * factor * pb],
        ))
    res = client.result()
    check(res.result, expected)


# -------------------------------------------------------- Poseidon streaming
#
# The reference's engine hashes leaves while elements are still being fed
# and the result drain runs concurrently (integration_poseidon.rs:81-119).


def _poseidon_setup(height, stream_leaves):
    from blaze_tpu.fields import FIELDS
    from blaze_tpu.hash.tree import LEAF_ARITY, base_layer_size
    from blaze_tpu.runtime import PoseidonClient, PoseidonInitializeParameters

    spec = FIELDS["bls12_381_fr"]
    nleaves = base_layer_size(height)
    rng = np.random.default_rng(5)
    elems = rng.integers(
        0, 1 << 16, size=(nleaves * LEAF_ARITY, spec.nlimbs), dtype=np.uint16
    ).astype(np.uint32)
    cl = PoseidonClient(spec)
    cl.initialize(PoseidonInitializeParameters(
        tree_height=height, stream_leaves=stream_leaves))
    return spec, nleaves, elems, cl


def _reference_records(spec, elems, height):
    from blaze_tpu.hash.tree import num_tree_nodes
    from blaze_tpu.runtime import PoseidonClient, PoseidonInitializeParameters

    cl = PoseidonClient(spec)
    cl.initialize(PoseidonInitializeParameters(tree_height=height))
    cl.set_data(elems)
    cl.start_process()
    cl.wait_result()
    return cl.result(num_tree_nodes(height))


def test_poseidon_streaming_incremental():
    """Deterministic feed-while-hash: leaf records are drainable BEFORE
    the last element arrives, and the closed tree matches the
    non-streaming build bit for bit."""
    from blaze_tpu.hash.tree import LEAF_ARITY, num_tree_nodes

    height = 3                                       # 64 leaves
    spec, nleaves, elems, cl = _poseidon_setup(height, stream_leaves=16)

    half = (nleaves // 2) * LEAF_ARITY
    cl.set_data(elems[:half])                        # 2 complete blocks
    early = cl.drain_stream()
    assert len(early) == nleaves // 2                # results before done
    assert cl.get_last_node_id_in_ring() == nleaves // 2
    assert cl.get_num_of_pending_results() == 0      # drained

    cl.set_data(elems[half:])
    cl.start_process()
    cl.wait_result()
    recs = cl.result(num_tree_nodes(height))
    assert len(recs) == num_tree_nodes(height)

    ref = _reference_records(spec, elems, height)
    assert [r.hash for r in recs] == [r.hash for r in ref]
    # the streamed leaf records ARE the final leaf layer prefix
    assert [r.hash for r in early] == [r.hash for r in ref[: nleaves // 2]]
    assert [r.hash_id for r in early] == list(range(nleaves // 2))


def test_poseidon_streaming_producer_consumer():
    """Threaded feeder + drainer sharing one client (the reference's
    rayon scope_fifo + Arc<Mutex> pair)."""
    import threading
    import time

    from blaze_tpu.hash.tree import LEAF_ARITY, num_tree_nodes

    height = 3
    spec, nleaves, elems, cl = _poseidon_setup(height, stream_leaves=8)

    drained = []
    feed_done = threading.Event()

    def feeder():
        step = LEAF_ARITY * 4                        # 4 leaves per call
        for i in range(0, elems.shape[0], step):
            cl.set_data(elems[i : i + step])
            time.sleep(0.002)
        feed_done.set()

    def drainer():
        while not feed_done.is_set():
            drained.extend(cl.drain_stream())
            time.sleep(0.002)
        drained.extend(cl.drain_stream())

    tf = threading.Thread(target=feeder)
    td = threading.Thread(target=drainer)
    tf.start()
    td.start()
    tf.join()
    td.join()

    assert len(drained) == nleaves
    assert [r.hash_id for r in drained] == list(range(nleaves))

    cl.start_process()
    cl.wait_result()
    recs = cl.result(num_tree_nodes(height))
    ref = _reference_records(spec, elems, height)
    assert [r.hash for r in recs] == [r.hash for r in ref]
    assert [r.hash for r in drained] == [r.hash for r in ref[:nleaves]]
