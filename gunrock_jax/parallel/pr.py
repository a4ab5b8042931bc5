"""Multi-chip PageRank: vertex-sharded pull SpMV over the mesh.

The reference's multi-GPU PR exchanges rank value-associates per superstep
(``app/pr/pr_enactor.cuh:1109``). Here ranks are sharded ``(S,)`` per
device; each iteration ships boundary ranks over NVLink (NCCL
all-to-all) and segment-sums each shard's owned in-edges locally.
Convergence is a ``psum`` of per-shard updated-vertex counts (reference
Stop_Condition ``pr_enactor.cuh:864-884``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..enactor import Timer
from ..graph.csr import CsrGraph
from ..utils.info import make_info
from .comm import ghost_exchange
from .mesh import AXIS, make_mesh
from ..ops.segment import row_reduce_sorted
from .partition import PartitionedGraph, partition

__all__ = ["pagerank_sharded", "pagerank_sharded_device",
           "ShardedPrResult"]


@dataclasses.dataclass
class ShardedPrResult:
    ranks: np.ndarray
    node_ids: np.ndarray
    info: dict


def _make_pr_fn(pg: PartitionedGraph, *, damping: float, normalized: bool,
                comm_latency: int, axis: str, mesh: Mesh):
    S = pg.shard_size
    p = pg.num_shards
    n = pg.num_nodes
    G = pg.ghost_cap
    reset = (1.0 - damping) / n if normalized else (1.0 - damping)

    def shard_fn(row, col_local, send_idx, out_deg_local, vmask_local,
                 max_iters, threshold):
        row = row.reshape(-1)             # (S+1,) csc offsets of owned verts
        col_local = col_local.reshape(-1)  # (E,) local value-table ids
        send_idx = send_idx.reshape(p, G)  # my producer table
        out_deg_local = out_deg_local.reshape(-1)   # (S,)
        vmask_local = vmask_local.reshape(-1)       # (S,) real-vertex mask
        lane = jnp.arange(col_local.shape[0], dtype=jnp.int32)

        inv_deg_local = jnp.where(out_deg_local > 0,
                                  1.0 / jnp.maximum(out_deg_local, 1.0), 0.0)
        rank0 = jnp.where(vmask_local,
                          (1.0 / n) if normalized else (1.0 - damping),
                          0.0).astype(jnp.float32)

        def cond(carry):
            rank, num_updated, it = carry
            return (num_updated > 0) & (it < max_iters)

        def body(carry):
            rank, _, it = carry
            contrib_local = rank * inv_deg_local
            # Boundary-only exchange (reference ships boundary
            # associates, enactor_helper.cuh:297-405): O(ghosts) on the
            # interconnect, not O(V).
            table = ghost_exchange(axis, contrib_local, send_idx,
                                   comm_latency=comm_latency)
            vals = table[jnp.where(lane < row[-1], col_local, 0)]
            incoming = row_reduce_sorted(vals, row, op="sum")
            new_rank = jnp.where(vmask_local, reset + damping * incoming,
                                 0.0)
            updated = vmask_local & (jnp.abs(new_rank - rank) > threshold)
            num_updated = jax.lax.psum(
                jnp.sum(updated.astype(jnp.int32)), axis)
            return new_rank, num_updated, it + 1

        rank, _, iters = jax.lax.while_loop(
            cond, body, (rank0, jnp.int32(1), jnp.int32(0)))
        return rank, iters

    in_specs = (P(AXIS, None), P(AXIS, None), P(AXIS, None, None), P(AXIS),
                P(AXIS), P(), P())
    out_specs = (P(AXIS), P())
    return jax.jit(jax.shard_map(shard_fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs))


def pagerank_sharded_device(pg: PartitionedGraph, *, mesh: Optional[Mesh],
                            out_degrees_new: jax.Array,
                            vmask_new: jax.Array, damping: float = 0.85,
                            threshold: float = 1e-6, max_iters: int = 50,
                            normalized: bool = True,
                            comm_latency: int = 0):
    if not pg.has_ghosts:
        raise ValueError("sharded PageRank needs partition(with_ghosts=True)")
    if mesh is None:
        mesh = make_mesh(pg.num_shards)
    fn = _make_pr_fn(pg, damping=float(damping), normalized=normalized,
                     comm_latency=comm_latency, axis=AXIS, mesh=mesh)
    return fn(pg.csc_offsets, pg.csc_local, pg.ghost_send_idx,
              out_degrees_new.reshape(pg.num_shards, pg.shard_size),
              vmask_new.reshape(pg.num_shards, pg.shard_size),
              jnp.int32(max_iters), jnp.float32(threshold))


def pagerank_sharded(graph: CsrGraph, *, num_shards: int = None,
                     partition_method: str = "random", seed: int = 0,
                     mesh: Optional[Mesh] = None, damping: float = 0.85,
                     threshold: float = 1e-6, max_iters: int = 50,
                     normalized: bool = True,
                     comm_latency: int = 0) -> ShardedPrResult:
    """Partition ``graph`` and run PageRank across the mesh; only
    boundary ranks cross the interconnect."""
    timer = Timer()
    if mesh is None:
        mesh = make_mesh(num_shards)
    num_shards = mesh.devices.size

    with timer.time("partition_ms"):
        pg, perm = partition(graph, num_shards, method=partition_method,
                             seed=seed, with_csc=True, with_ghosts=True)
        v_pad = pg.v_global_pad
        out_deg_new = np.zeros(v_pad, np.float32)
        out_deg_new[perm] = np.diff(graph.row_offsets).astype(np.float32)
        vmask_new = np.zeros(v_pad, bool)
        vmask_new[perm] = True

    with timer.time("process_ms"):
        rank, iters = jax.block_until_ready(pagerank_sharded_device(
            pg, mesh=mesh, out_degrees_new=jnp.asarray(out_deg_new),
            vmask_new=jnp.asarray(vmask_new), damping=damping,
            threshold=threshold, max_iters=max_iters,
            normalized=normalized, comm_latency=comm_latency))

    ranks_old = np.asarray(rank)[perm]
    order = np.argsort(-ranks_old, kind="stable").astype(np.int32)
    # boundary-exchange volume: p*ghost_cap values per shard per superstep
    bytes_per_step = num_shards * (num_shards - 1) * pg.ghost_cap * 4
    info = make_info(
        primitive="pagerank_sharded", graph=graph, timer=timer,
        edges_visited=graph.num_edges * int(iters),
        extra={"num_shards": int(num_shards), "damping": damping,
               "num_iterations": int(iters),
               "partition_method": partition_method,
               "ghost_cap": int(pg.ghost_cap),
               "comm_bytes_per_superstep": int(bytes_per_step),
               "comm_bytes": int(bytes_per_step) * int(iters),
               "comm_latency_rounds": comm_latency},
    )
    return ShardedPrResult(ranks=ranks_old, node_ids=order, info=info)
