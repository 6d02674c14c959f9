"""Five-phase client lifecycle tests (the reference's integration-test
flows, hardware-free): initialize -> set_data -> start -> wait -> result."""
import random

import numpy as np
import pytest

from blaze_tpu.curves import CURVES, decode_projective_result
from blaze_tpu.fields import FIELDS, int_to_limbs, limbs_to_int, limbs_to_bytes
from blaze_tpu.hash.tree import num_tree_nodes, LEAF_ARITY, base_layer_size
from blaze_tpu.oracle import ECOracle, random_msm_instance
from blaze_tpu.runtime import (
    DeviceContext,
    MSMClient,
    MSMInit,
    MSMInput,
    MSMParams,
    NTTClient,
    NTTInit,
    NTTInput,
    PoseidonClient,
    PoseidonInitializeParameters,
)
from blaze_tpu.curves import encode_affine_points, encode_scalars


N = 32
CURVE = "bn254"


def make_wire_input(seed=50):
    spec = CURVES[CURVE]
    points, scalars, expected, _ = random_msm_instance(spec, N, seed)
    return (
        encode_affine_points(points, spec),
        encode_scalars(scalars, spec),
        expected,
    )


def check_result(raw, expected):
    """Oracle-style check: parse z||y||x, normalize, compare affine
    (tests/msm/mod.rs:397-419 flow)."""
    spec = CURVES[CURVE]
    proj = decode_projective_result(raw, spec)
    x, y, z = (limbs_to_int(proj[i]) for i in range(3))
    oracle = ECOracle(spec)
    p = spec.fq.p
    zinv = pow(z, -1, p)
    pt = (x * zinv % p, y * zinv % p)
    assert oracle.on_curve(pt)
    assert pt == expected


def test_msm_client_dma_mode():
    praw, sraw, expected = make_wire_input()
    client = MSMClient(MSMInit(curve="BN254", mem_type="dma"))
    img = client.loaded_binary_parameters()
    assert img.fields["point_bytes"] == 64      # msm_cfg.rs BN254 contract
    assert img.fields["result_bytes"] == 96

    client.initialize(MSMParams(nof_elements=N))
    client.set_data(MSMInput(scalars=sraw, points=praw))
    assert not client.is_msm_engine_ready() or client.pending_tasks == 0
    client.start_process()
    assert client.pending_tasks == 1
    client.wait_result()
    res = client.result()
    assert res is not None and res.label == 0
    check_result(res.result, expected)
    assert client.pending_tasks == 0
    assert client.timings.total_s > 0
    api = client.get_api()
    assert api["task_label"] == 1


def test_msm_client_hbm_point_reuse():
    """Mode 2 (load points under key) then mode 3 (scalars only) —
    README.md:95-113 contract."""
    spec = CURVES[CURVE]
    praw, sraw, expected = make_wire_input(seed=51)
    client = MSMClient(MSMInit(curve=CURVE, mem_type="hbm"))
    params = MSMParams(nof_elements=N, hbm_point_addr="bank0")
    client.initialize(params)
    client.set_data(MSMInput(scalars=sraw, points=praw))  # mode 2
    client.start_process()
    r1 = client.result()
    check_result(r1.result, expected)

    # mode 3: same points from cache, fresh scalars
    _, sraw2, _ = make_wire_input(seed=51)  # same seed -> same expected
    client.set_data(MSMInput(scalars=sraw2, points=None))
    client.start_process()
    r2 = client.result()
    assert r2.label == 1
    check_result(r2.result, expected)

    # scalars-only without a cached key must fail
    client2 = MSMClient(MSMInit(curve=CURVE))
    client2.initialize(MSMParams(nof_elements=N))
    with pytest.raises(RuntimeError):
        client2.set_data(MSMInput(scalars=sraw, points=None))


def test_msm_client_task_queue_depth():
    """Multiple tasks in flight at once: push 3, pop 3 labeled results in
    FIFO order (the reference's multi-deep queue, msm_hw_code.rs:19-25) —
    a second start_process must not clobber the first's result."""
    spec = CURVES[CURVE]
    client = MSMClient(MSMInit(curve=CURVE))
    client.initialize(MSMParams(nof_elements=N))

    expects = []
    for seed in (70, 71, 72):
        praw, sraw, expected = make_wire_input(seed=seed)
        client.set_data(MSMInput(scalars=sraw, points=praw))
        client.start_process()
        expects.append(expected)
    assert client.pending_tasks == 3
    assert not client.is_msm_engine_ready()

    for i, expected in enumerate(expects):
        res = client.result()
        assert res.label == i
        check_result(res.result, expected)
    assert client.pending_tasks == 0
    assert client.is_msm_engine_ready()
    assert client.result() is None


def test_ntt_client_double_buffered_pipeline():
    """The reference's pipelined 3-vector flow (integration_ntt.rs:63-146):
    alternate buffers, kernel on one while host fills the other."""
    spec = FIELDS["bn254_fr"]
    logn, n = 6, 64
    rng = random.Random(52)
    vectors = [
        [rng.randrange(spec.p) for _ in range(n)] for _ in range(3)
    ]
    raws = [
        limbs_to_bytes(
            np.stack([int_to_limbs(v, spec.nlimbs) for v in vec]), spec
        )
        for vec in vectors
    ]

    fwd = NTTClient(NTTInit(field="bn254_fr", logn=logn))
    inv = NTTClient(NTTInit(field="bn254_fr", logn=logn), inverse=True)
    fwd.initialize()

    outs = {}
    for i, raw in enumerate(raws):
        buf_host = i % 2
        buf_kernel = 1 - buf_host
        fwd.set_data(NTTInput(data=raw, buf_host=buf_host))
        fwd.start_process(buf_host)
        fwd.wait_result()
        outs[i] = fwd.result(buf_host)
        assert outs[i] is not None and len(outs[i]) == n * spec.nbytes

    # roundtrip through the inverse client reproduces input bytes exactly
    inv.set_data(NTTInput(data=outs[0], buf_host=0))
    inv.start_process(0)
    inv.wait_result()
    assert inv.result(0) == raws[0]


def test_poseidon_client_tree_build():
    """Height-2 build via the streaming client (the height-4/585-node flow
    of integration_poseidon.rs:122-169, shrunk for CI)."""
    spec = FIELDS["bls12_381_fr"]
    height = 2
    nleaves = base_layer_size(height)
    client = PoseidonClient(field="bls12_381_fr")
    client.initialize(PoseidonInitializeParameters(tree_height=height))

    rng = random.Random(53)
    total = 0
    for _ in range(nleaves):
        for _ in range(LEAF_ARITY):  # 11 elements per leaf, like the tests
            v = rng.randrange(spec.p)
            client.set_data(
                limbs_to_bytes(int_to_limbs(v, spec.nlimbs)[None], spec)
            )
            total += 1
            assert client.get_last_element_sent_to_ring() == total

    client.start_process()
    client.wait_result()
    recs = client.result(expected_count=num_tree_nodes(height))
    assert len(recs) == num_tree_nodes(height)  # 9 for height 2
    assert recs[0].layer_id == 0 and recs[0].hash_id == 0
    assert recs[-1].layer_id == height - 1
    # wrong expected count raises (the drain-contract check)
    client.start_process()
    with pytest.raises(RuntimeError):
        client.result(expected_count=999)


def test_device_context_health():
    ctx = DeviceContext()
    h = ctx.health()
    assert h.platform in ("cpu", "gpu")
    assert h.ok()
    assert ctx.num_devices >= 1


def test_client_api_dumps():
    """Every client exposes the register-dump analog (get_api) with the
    timing + health surface (msm_api.rs:324-330, poseidon_api.rs:245-253,
    ntt_hw_code.rs status regs)."""
    from blaze_tpu.runtime.clients import (
        MSMClient, MSMInit, NTTClient, NTTInit, PoseidonClient,
    )

    m = MSMClient(MSMInit(curve="bn254")).get_api()
    assert {"pending_tasks", "timings", "health"} <= set(m)
    n = NTTClient(NTTInit(field="bn254_fr", logn=4)).get_api()
    assert n["buffers"] == {0: "empty", 1: "empty"}
    p = PoseidonClient()
    d = p.get_api()
    assert d["elements_staged"] == 0 and d["pending_results"] == 0
