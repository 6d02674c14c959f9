"""Device-time split of a profiled window, read from a `jax.profiler` trace.

`device_split(logdir)` sums the durations of the device's kernel events
by phase — the jitted module that launched them (`hlo_module`), mapped
through `MSM_PHASES` — and reports the device's busy time, the window's
span and the idle share (1 - busy / span, busy as the union of event
intervals).  Kernels whose name, op or scope mentions a sort count as
`sort` whatever module launched them; modules missing from the phase map
count as `other`.
"""
from __future__ import annotations

import glob
import os

# jitted-module name -> phase (msm/pippenger.py's separately jitted steps)
MSM_PHASES = {
    "jit__digits_jit": "digits",
    "jit__scan_phase_jit": "scan",
    "jit__bucket_phase_jit": "bucket",
    "jit__fold_jit": "fold",
    "jit__add_wsums": "accumulate",
}


def _latest_xplane(logdir: str) -> str:
    paths = sorted(glob.glob(os.path.join(
        logdir, "plugins", "profile", "*", "*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {logdir}")
    return paths[-1]


def device_split(logdir: str, phases: dict | None = None,
                 device_prefix: str = "/device:GPU") -> dict:
    """`split_events` over the planes whose name starts with
    `device_prefix` in the newest trace in `logdir` (`/host:CPU` reads
    the trace of a CPU run)."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(_latest_xplane(logdir))
    return split_events(
        ((ev.name, dict(ev.stats), ev.start_ns, ev.duration_ns)
         for plane in pd.planes if plane.name.startswith(device_prefix)
         for line in plane.lines for ev in line.events),
        phases)


def split_events(events, phases: dict | None = None) -> dict:
    """{phase: seconds, ..., "busy_s", "span_s", "idle_share"} of
    (name, stats, start_ns, duration_ns) kernel events; events without an
    `hlo_module` stat are not kernels and are skipped."""
    phases = MSM_PHASES if phases is None else phases
    split: dict = {}
    intervals = []
    for name, stats, start_ns, dur_ns in events:
        module = stats.get("hlo_module")
        if module is None:
            continue
        names = f"{name} {stats.get('hlo_op', '')} " \
                f"{stats.get('tf_op', '')}".lower()
        phase = "sort" if "sort" in names else phases.get(module, "other")
        dur = dur_ns * 1e-9
        split[phase] = split.get(phase, 0.0) + dur
        start = start_ns * 1e-9
        intervals.append((start, start + dur))
    if not intervals:
        raise ValueError("no device kernel events in the trace")
    intervals.sort()
    busy, cur_s, cur_e = 0.0, *intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = max(e for _, e in intervals) - intervals[0][0]
    split["busy_s"] = busy
    split["span_s"] = span
    split["idle_share"] = 1.0 - busy / span if span else 0.0
    return split
