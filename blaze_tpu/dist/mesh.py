"""Mesh bootstrap — the multi-card management layer the reference leaves
unimplemented (`/root/reference/README.md:20-22`: connection pooling and
multi-card state machines are 'for the management layer').

Here one `jax.sharding.Mesh` replaces the per-slot DriverClient connection;
XLA collectives over the device interconnect (NVLink between the GPUs of
one host) replace the PCIe DMA transport.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Multi-host bootstrap (jax.distributed). No-op for single process."""
    if coordinator is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(axes: dict, devices: Optional[Sequence] = None) -> Mesh:
    """Named mesh, e.g. make_mesh({'dp': 4, 'sp': 2})."""
    devs = list(devices) if devices is not None else jax.devices()
    shape = tuple(axes.values())
    n = int(np.prod(shape))
    if n > len(devs):
        raise ValueError(f"mesh {axes} wants {n} devices, have {len(devs)}")
    return Mesh(np.asarray(devs[:n]).reshape(shape), tuple(axes.keys()))


def shard_leading(mesh: Mesh, axis: str):
    """NamedSharding partitioning the leading array dim over one mesh axis."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh):
    return NamedSharding(mesh, P())
