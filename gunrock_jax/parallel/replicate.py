"""Replicated ("duplicate") execution: full graph on every chip, batched
sources split across the mesh.

The reference's DuplicatePartitioner (``app/dup/dup_partitioner.cuh``)
replicates the whole graph per GPU; its use case is throughput on batched
queries (multi-source BFS, multi-source/all-source BC). Here:
the DeviceGraph pytree is replicated across a 1-D mesh (``P()`` specs) and
the SOURCE batch is sharded — each chip runs the unmodified single-chip
primitive loop for its sources, and per-vertex accumulations combine with
one final ``psum``. Zero inter-chip traffic during traversal: the ideal
weak-scaling regime the reference's dup method targets.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..enactor import Timer, capacity_ladder
from ..graph.csr import CsrGraph
from ..graph.device import DeviceGraph, to_device
from ..utils.info import make_info
from .mesh import AXIS, make_mesh, pvary

__all__ = ["bc_batch", "bfs_batch", "BatchBcResult", "BatchBfsResult"]


@dataclasses.dataclass
class BatchBcResult:
    bc_values: np.ndarray      # (V,) summed over the source batch
    info: dict


@dataclasses.dataclass
class BatchBfsResult:
    labels: np.ndarray         # (num_sources, V) int32 depths
    info: dict


def _graph_specs(graph: DeviceGraph):
    return jax.tree.map(lambda _: P(), graph)


def _prep(graph: Union[CsrGraph, DeviceGraph], sources, mesh, timer,
          **to_device_kw):
    if mesh is None:
        mesh = make_mesh()
    p = mesh.devices.size
    if isinstance(graph, CsrGraph):
        with timer.time("preprocess_ms"):
            dg = to_device(graph, **to_device_kw)
    else:
        dg = graph
    srcs = np.asarray(list(sources), dtype=np.int32)
    if srcs.size == 0:
        raise ValueError("empty source batch")
    if (srcs < 0).any() or (srcs >= dg.num_nodes).any():
        raise ValueError("source out of range")
    k = -(-srcs.size // p)
    padded = np.full(p * k, -1, np.int32)
    padded[: srcs.size] = srcs
    return dg, jnp.asarray(padded), mesh, p, k


def bc_batch(graph: Union[CsrGraph, DeviceGraph],
             sources: Sequence[int], *, mesh: Optional[Mesh] = None,
             queue_sizing: float = 1.0) -> BatchBcResult:
    """Multi-source Brandes BC with sources fanned across the mesh on a
    replicated graph; returns per-vertex centrality summed over the batch
    (×0.5 undirected scaling, matching ``models.bc``). This is the
    reference's "duplicate" execution mode (``app/dup``)."""
    from ..models.bc import _bc_loop

    timer = Timer()
    num_nodes = graph.num_nodes
    dg, srcs, mesh, p, k = _prep(graph, sources, mesh, timer)
    fcap = max(128, int(dg.v_pad * min(queue_sizing, 1.0)))
    caps = tuple(capacity_ladder(
        max(128, int(dg.e_pad * min(queue_sizing, 1.0)))))

    def shard_fn(graph, srcs_local):
        srcs_local = srcs_local.reshape(-1)

        def body(i, acc):
            s = srcs_local[i]
            vals, _, _, _ = _bc_loop(graph, jnp.maximum(s, 0),
                                     fcap=fcap, caps=caps)
            return acc + jnp.where(s >= 0, vals, 0.0)

        acc = jax.lax.fori_loop(
            0, k, body, pvary(jnp.zeros((dg.v_pad,), jnp.float32), AXIS))
        return jax.lax.psum(acc, AXIS)

    # check_vma=False: the single-chip loops inside carry
    # invariant-initialized state that the varying-manual-axes analysis
    # rejects under shard_map; shards are fully independent here (one
    # psum at the end), so the check adds nothing.
    fn = jax.jit(jax.shard_map(
        shard_fn, mesh=mesh, in_specs=(_graph_specs(dg), P(AXIS)),
        out_specs=P(), check_vma=False))
    with timer.time("process_ms"):
        vals = jax.block_until_ready(fn(dg, srcs))

    bc_vals = (np.asarray(vals)[:num_nodes] * 0.5).astype(np.float32)
    info = make_info(
        primitive="bc_batch", graph=dg, stats=None, timer=timer,
        edges_visited=2 * dg.num_edges * int(np.sum(np.asarray(srcs) >= 0)),
        extra={"num_sources": int(np.sum(np.asarray(srcs) >= 0)),
               "num_shards": p, "replicated": True,
               "partition_method": "duplicate"},
    )
    return BatchBcResult(bc_values=bc_vals, info=info)


def bfs_batch(graph: Union[CsrGraph, DeviceGraph],
              sources: Sequence[int], *, mesh: Optional[Mesh] = None,
              queue_sizing: float = 1.0) -> BatchBfsResult:
    """Batched multi-source BFS on a replicated graph: sources split
    across the mesh, each chip traverses its slice with the single-chip
    loop; per-source label vectors all-gather back."""
    from ..models.bfs import _bfs_loop

    timer = Timer()
    num_nodes = graph.num_nodes
    dg, srcs, mesh, p, k = _prep(graph, sources, mesh, timer)
    fcap = max(128, int(dg.v_pad * min(queue_sizing, 1.0)))
    caps = tuple(capacity_ladder(
        max(128, int(dg.e_pad * min(queue_sizing, 1.0)))))

    def shard_fn(graph, srcs_local):
        srcs_local = srcs_local.reshape(-1)

        def body(i, out):
            s = srcs_local[i]
            state, _ = _bfs_loop(
                graph, jnp.maximum(s, 0), jnp.int32(dg.num_nodes + 1),
                fcap=fcap, caps=caps, mark_preds=False,
                direction_optimized=False, alpha=15.0, beta=18.0,
                init=True)
            lab = jnp.where(s >= 0, state.labels, -1)
            return jax.lax.dynamic_update_slice(out, lab[None, :], (i, 0))

        out0 = pvary(jnp.full((k, dg.v_pad), -1, jnp.int32), AXIS)
        return jax.lax.fori_loop(0, k, body, out0)

    fn = jax.jit(jax.shard_map(
        shard_fn, mesh=mesh, in_specs=(_graph_specs(dg), P(AXIS)),
        out_specs=P(AXIS), check_vma=False))
    with timer.time("process_ms"):
        labels = jax.block_until_ready(fn(dg, srcs))

    n_src = int(np.sum(np.asarray(srcs) >= 0))
    labels_np = np.asarray(labels)[:n_src, :num_nodes]
    info = make_info(
        primitive="bfs_batch", graph=dg, stats=None, timer=timer,
        edges_visited=dg.num_edges * n_src,
        extra={"num_sources": n_src, "num_shards": p, "replicated": True,
               "partition_method": "duplicate"},
    )
    return BatchBfsResult(labels=labels_np, info=info)
