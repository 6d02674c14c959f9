"""Device context — the DriverClient / shell analog.

The reference's DriverClient opens three XDMA character devices per card
slot and exposes register/DMA I/O, bitstream loading, firewalls and CMS
sensors (`reference/src/driver_client/dclient.rs:50-151`).  On the GPU
the PJRT runtime replaces the transport; what remains useful is:

  * connection: pick a device / build a mesh (the slot-id analog,
    dclient.rs:79-86 — a Mesh replaces the per-slot connection);
  * 'binary load': ahead-of-time compilation warm-up of a client's kernels
    (load_binary, dclient.rs:213-236 — compile caches replace bitstreams);
  * health/telemetry: memory stats and live-array accounting in place of
    CMS sensors and AXI firewall status (dclient.rs:115-151, 566-579).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional, Sequence

import jax
import numpy as np


@dataclasses.dataclass
class DeviceHealth:
    """CMS-sensor analog (initialize_cms / HBM temp monitoring,
    dclient.rs:115-151)."""

    platform: str
    device_kind: str
    bytes_in_use: Optional[int]
    bytes_limit: Optional[int]
    peak_bytes_in_use: Optional[int]

    def ok(self) -> bool:
        if self.bytes_in_use is None or self.bytes_limit in (None, 0):
            return True
        return self.bytes_in_use <= self.bytes_limit


class DeviceContext:
    """One 'connection': a device (or mesh of devices) + telemetry."""

    def __init__(self, device_id: int = 0, devices: Optional[Sequence] = None):
        self._all = list(devices) if devices is not None else jax.devices()
        if device_id >= len(self._all):
            raise ValueError(
                f"device_id {device_id} out of range ({len(self._all)} devices)"
            )
        self.device = self._all[device_id]
        self.device_id = device_id

    @property
    def num_devices(self) -> int:
        return len(self._all)

    def make_mesh(self, shape: dict):
        """Named mesh over this context's devices, e.g. {'dp': 4, 'sp': 2}."""
        names = tuple(shape.keys())
        dims = tuple(shape.values())
        n = int(np.prod(dims))
        if n > len(self._all):
            raise ValueError(f"mesh wants {n} devices, have {len(self._all)}")
        devs = np.asarray(self._all[:n]).reshape(dims)
        return jax.sharding.Mesh(devs, names)

    # ------------------------------------------------------------- health
    def health(self) -> DeviceHealth:
        stats = {}
        try:
            stats = self.device.memory_stats() or {}
        except Exception:
            pass
        return DeviceHealth(
            platform=self.device.platform,
            device_kind=getattr(self.device, "device_kind", "unknown"),
            bytes_in_use=stats.get("bytes_in_use"),
            bytes_limit=stats.get("bytes_limit"),
            peak_bytes_in_use=stats.get("peak_bytes_in_use"),
        )

    def live_buffers(self) -> int:
        """Firewall-status analog: count of live arrays on this device."""
        try:
            return sum(
                1
                for a in jax.live_arrays()
                if self.device in getattr(a, "devices", lambda: set())()
            )
        except Exception:
            return -1

    # ----------------------------------------------------------- profiler
    @contextlib.contextmanager
    def profile(self, trace_dir: str):
        """Capture a device profile around a block — the device analog of the
        reference's hardware perf counters (per-phase busy/total clocks and
        FIFO occupancy, msm_hw_code.rs:35-54).  Writes a TensorBoard /
        Perfetto trace with per-kernel device times to `trace_dir`:

            with ctx.profile("/tmp/msm_trace"):
                client.start_process(); client.wait_result()
        """
        with jax.profiler.trace(trace_dir):
            yield

    # ---------------------------------------------------------- 'binary'
    def load_binary(self, warmup_fns: Sequence) -> float:
        """AOT-compile a client's kernels (the bitstream-load analog).

        Each entry is a zero-arg callable triggering compilation.  Returns
        wall seconds spent — the load_binary timing surface
        (dclient.rs:213-236).
        """
        from ..utils.errors import LoadFailed

        t0 = time.perf_counter()
        for fn in warmup_fns:
            try:
                out = fn()
                jax.block_until_ready(out)
            except Exception as e:
                raise LoadFailed(
                    f"kernel warm-up failed for {getattr(fn, '__name__', fn)}: {e}"
                ) from e
        return time.perf_counter() - t0
