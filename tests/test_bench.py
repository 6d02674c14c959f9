"""Peak table, compile-cache placement and the trace reduction."""
import jax
import jax.numpy as jnp
import pytest

from blaze_tpu.bench.profile import SOL_TABLE, speed_of_light
from blaze_tpu.bench.trace import device_split, split_events
from blaze_tpu.utils import cache


def test_h100_peak_row():
    sol = speed_of_light("NVIDIA H100 80GB HBM3")
    assert sol.hbm_gbps == 3350.0
    assert sol.bf16_tflops == 989.0 and sol.int8_tops == 1979.0
    assert "data sheet" in sol.source


def test_unknown_device_kind_raises():
    assert "cpu" not in SOL_TABLE
    with pytest.raises(KeyError):
        speed_of_light("cpu")


def test_cache_dir_honours_env(monkeypatch):
    calls = []
    monkeypatch.setenv(cache.ENV_VAR, "/elsewhere/cache")
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append(k))
    assert cache.setup_compile_cache() == "/elsewhere/cache"
    assert "jax_compilation_cache_dir" not in calls


def test_cache_dir_fixed_default(monkeypatch):
    calls = {}
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    path = cache.setup_compile_cache()
    assert path == cache.DEFAULT_DIR == calls["jax_compilation_cache_dir"]
    assert path.endswith(".jax_cache")
    assert cache.compile_cache_dir("mh1") == f"{cache.DEFAULT_DIR}/mh1"


def test_split_events_phases_and_intervals():
    ms = 1_000_000
    events = [
        # (name, stats, start_ns, duration_ns)
        ("fusion.1", {"hlo_module": "jit__digits_jit"}, 0, 2 * ms),
        ("sort.0", {"hlo_module": "jit__scan_phase_jit"}, 1 * ms, 3 * ms),
        ("loop_fusion", {"hlo_module": "jit__scan_phase_jit"}, 10 * ms, 4 * ms),
        ("copy", {"hlo_module": "jit_unknown"}, 12 * ms, 1 * ms),
        ("host work", {}, 20 * ms, 50 * ms),           # not a kernel
    ]
    got = split_events(events)
    assert got["digits"] == pytest.approx(0.002)
    assert got["sort"] == pytest.approx(0.003)
    assert got["scan"] == pytest.approx(0.004)
    assert got["other"] == pytest.approx(0.001)
    # union of [0, 4] and [10, 14] ms; span 0 -> 14 ms
    assert got["busy_s"] == pytest.approx(0.008)
    assert got["span_s"] == pytest.approx(0.014)
    assert got["idle_share"] == pytest.approx(1 - 8 / 14)


def test_split_events_needs_kernels():
    with pytest.raises(ValueError):
        split_events([("python", {}, 0, 10)])


def test_device_split_of_a_cpu_trace(tmp_path):
    from blaze_tpu.curves import CURVES, Curve
    from blaze_tpu.msm import MSM, MSMConfig
    from blaze_tpu.oracle import random_msm_instance

    spec = CURVES["bn254"]
    curve = Curve(spec)
    msm = MSM(curve, MSMConfig(chunk_log2=4))
    points, scalars, _, _ = random_msm_instance(spec, 32, 5)
    pts, scal = curve.fq.to_mont(jnp.asarray(points)), jnp.asarray(scalars)
    jax.block_until_ready(msm(pts, scal, window_bits=4))       # compile
    jax.profiler.start_trace(str(tmp_path))
    jax.block_until_ready(msm(pts, scal, window_bits=4))
    jax.profiler.stop_trace()
    got = device_split(str(tmp_path), device_prefix="/host:CPU")
    assert {"digits", "scan", "bucket", "fold", "accumulate"} <= set(got)
    assert 0 < got["busy_s"] <= got["span_s"]
    assert 0 <= got["idle_share"] < 1
