"""Device mesh helpers for multi-chip execution.

The reference selects GPUs with ``--device=0,1,...`` and drives one CPU
thread per GPU (``util/multithreading.cuh``); here one process drives a
1-D ``jax.sharding.Mesh`` over the graph-parallel axis — NVLink (NCCL)
carries the frontier all-to-all, and XLA's async collectives subsume the
reference's per-peer stream/event pipeline.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "shard_leading", "replicated", "AXIS", "pvary"]

AXIS = "shard"  # graph-parallel axis name


def pvary(x, axis: str):
    """Mark a constant-initialized loop carry as device-varying (shard_map
    VMA check); no-op when already varying (``pcast`` refuses a
    varying-to-varying cast)."""
    if axis in jax.typeof(x).vma:
        return x
    return jax.lax.pcast(x, axis, to="varying")


def make_mesh(num_shards: int | None = None, axis: str = AXIS) -> Mesh:
    """1-D mesh over the first ``num_shards`` devices."""
    devices = jax.devices()
    if num_shards is None:
        num_shards = len(devices)
    if num_shards > len(devices):
        raise ValueError(
            f"requested {num_shards} shards but only {len(devices)} devices")
    return Mesh(devices[:num_shards], (axis,))


def shard_leading(mesh: Mesh, axis: str = AXIS) -> NamedSharding:
    """Shard the leading array dimension across the mesh."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
