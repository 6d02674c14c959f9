"""Kernel benchmarking + speed-of-light accounting.

The reference exposes hardware perf counters (per-phase total/busy clocks,
FIFO occupancy — `/root/reference/src/ingo_msm/msm_hw_code.rs:35-54`) and a
criterion harness that times the kernel loop only
(`reference/benches/ntt_bench.rs:33-42`, sample_size=10).  The
analog here:

  * `bench_kernel` — compile once, then min/median over N timed reps of a
    jitted callable (criterion's sample loop);
  * `speed_of_light` — the card's published peaks, keyed by
    `jax.Device.device_kind`; a device missing from the table is an error;
  * `scaling_efficiency` — throughput(N devices) / (N * throughput(1)).
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Sequence

import jax


@dataclasses.dataclass(frozen=True)
class SpeedOfLight:
    """Published per-card peaks, the denominators of roofline shares."""

    hbm_gbps: float          # HBM bandwidth, GB/s
    bf16_tflops: float       # dense tensor-core peak (limb code uses none)
    int8_tops: float         # dense tensor-core peak
    fp32_tflops: float       # non-tensor-core float32 peak
    source: str


# Key is `jax.Device.device_kind`.
SOL_TABLE: dict[str, SpeedOfLight] = {
    "NVIDIA H100 80GB HBM3": SpeedOfLight(
        hbm_gbps=3350.0, bf16_tflops=989.0, int8_tops=1979.0,
        fp32_tflops=67.0,
        source="NVIDIA H100 data sheet, SXM5, dense, at the 700 W limit",
    ),
}


@dataclasses.dataclass
class KernelStats:
    """One benchmarked kernel's times."""

    name: str
    compile_s: float
    best_s: float
    median_s: float
    reps: int

    def summary(self) -> str:
        return (f"{self.name}: best {self.best_s * 1e3:.3f} ms "
                f"(median {self.median_s * 1e3:.3f} ms, "
                f"compile {self.compile_s:.1f} s)")


def speed_of_light(kind: str | None = None) -> SpeedOfLight:
    """Peaks of `kind` (default: the first JAX device's kind)."""
    kind = kind or jax.devices()[0].device_kind
    if kind not in SOL_TABLE:
        raise KeyError(f"no published peaks for device kind {kind!r}")
    return SOL_TABLE[kind]


def bench_kernel(
    fn: Callable,
    args: Sequence,
    name: str = "kernel",
    reps: int = 10,
) -> KernelStats:
    """Time a (jitted) callable: one warm-up (compile), then `reps` runs.

    Mirrors the criterion loop (ntt_bench.rs:33-42) with sample_size=reps.
    """
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    compile_s = time.perf_counter() - t0

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)

    return KernelStats(
        name=name,
        compile_s=compile_s,
        best_s=min(times),
        median_s=statistics.median(times),
        reps=reps,
    )


def scaling_efficiency(throughput_by_n: dict[int, float]) -> dict[int, float]:
    """{n_devices: throughput} -> {n_devices: efficiency vs linear}.

    Read against linear scaling (1.0) at every measured width."""
    if 1 not in throughput_by_n:
        raise ValueError("need the 1-device throughput as the reference")
    t1 = throughput_by_n[1]
    return {n: t / (n * t1) for n, t in sorted(throughput_by_n.items())}
