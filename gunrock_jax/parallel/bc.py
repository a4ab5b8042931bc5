"""Multi-chip Betweenness Centrality (single-source Brandes).

The reference BC chains a forward BFS-like Iteration_Loop (sigma
accumulation via atomicAdd, ``bc_functor.cuh:70``) with a backward
Iteration_Loop replaying frontiers in reverse (delta accumulation,
``bc_functor.cuh:203-238``), exchanging sigmas/deltas as value-associates
and using backward partition tables.

Formulation — three level-synchronous phases under one shard_map,
all exchanging only boundary values via the ghost tables
(``ghost_exchange`` — O(ghosts) per superstep, the reference's
backward/forward conversion tables, ``partitioner_base.cuh:357-383``):

  1. labels: sharded BFS depths (boundary label exchange per level;
     pull over the local CSC rows of owned vertices)
  2. forward sweep d = 1..D: sigma[v] = sum of sigma[u] over in-neighbors
     u at depth d-1 (sorted segmented sum; per-level boundary sigma
     exchange = the reference's value-associates); labels exchanged once
  3. backward sweep d = D-1..0: delta[u] = sigma[u] * sum over
     out-neighbors v at depth d+1 of (1 + delta[v]) / sigma[v]
     (per-level boundary delta exchange; labels/sigmas exchanged once)

Everything is deterministic segmented arithmetic — no atomics, bitwise
reproducible.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..enactor import Timer
from ..graph.csr import CsrGraph
from ..utils.info import make_info
from .comm import ghost_exchange
from .mesh import AXIS, make_mesh, pvary
from ..ops.segment import row_reduce_sorted
from .partition import PartitionedGraph, partition

__all__ = ["bc_sharded", "bc_sharded_device", "ShardedBcResult"]


@dataclasses.dataclass
class ShardedBcResult:
    bc_values: np.ndarray
    sigmas: np.ndarray
    labels: np.ndarray
    info: dict


def _edge_valid(row, cap):
    lane = jnp.arange(cap, dtype=jnp.int32)
    return lane < row[-1]


def _make_bc_fn(pg: PartitionedGraph, *, comm_latency: int, axis: str,
                mesh: Mesh):
    S = pg.shard_size
    p = pg.num_shards
    Gb = pg.ghost_cap       # backward (in-edge) ghost cap
    Gf = pg.fwd_ghost_cap   # forward (out-edge) ghost cap

    def shard_fn(row, col_local, crow, ccol_local, bsend, fsend, src_new):
        # row/col_local: CSR of owned vertices (out-edges, local-table ids)
        # crow/ccol_local: CSC of owned vertices (in-edges, local-table ids)
        row = row.reshape(-1)
        col_local = col_local.reshape(-1)
        crow = crow.reshape(-1)
        ccol_local = ccol_local.reshape(-1)
        bsend = bsend.reshape(p, Gb)
        fsend = fsend.reshape(p, Gf)
        my_base = jax.lax.axis_index(axis).astype(jnp.int32) * S

        out_valid = _edge_valid(row, col_local.shape[0])
        in_valid = _edge_valid(crow, ccol_local.shape[0])
        col_safe = jnp.where(out_valid, col_local, 0)
        ccol_safe = jnp.where(in_valid, ccol_local, 0)

        def in_table(vals):
            """Boundary exchange over the in-edge (csc) ghost tables."""
            return ghost_exchange(axis, vals, bsend,
                                  comm_latency=comm_latency)

        def out_table(vals):
            """Boundary exchange over the out-edge (csr) ghost tables."""
            return ghost_exchange(axis, vals, fsend,
                                  comm_latency=comm_latency)

        lane = jnp.arange(S, dtype=jnp.int32)
        owns = (src_new >= my_base) & (src_new < my_base + S)
        labels = jnp.where(owns & (lane == src_new - my_base), 0, -1)
        labels = labels.astype(jnp.int32)

        # ---- phase 1: BFS depths (pull over in-edges each level;
        # boundary-only label exchange per level)
        def bfs_cond(carry):
            labels, changed, d = carry
            return changed > 0

        def bfs_body(carry):
            labels, _, d = carry
            lT = in_table(labels)
            hit = in_valid & (lT[ccol_safe] == d - 1)
            reached = row_reduce_sorted(hit.astype(jnp.int32), crow,
                                        op="sum") > 0
            new = (labels == -1) & reached
            labels = jnp.where(new, d, labels)
            changed = jax.lax.psum(jnp.sum(new.astype(jnp.int32)), axis)
            return labels, changed, d + 1

        labels, _, dmax = jax.lax.while_loop(
            bfs_cond, bfs_body, (labels, jnp.int32(1), jnp.int32(1)))
        depth = dmax - 1  # last level that discovered nothing

        # labels are static from here on: exchange once per direction
        lT_in = in_table(labels)
        lT_out = out_table(labels)

        # ---- phase 2: forward sigma sweep (per level: one boundary
        # exchange of sigmas — the reference's value-associates)
        sigma = jnp.where(labels == 0, 1.0, 0.0).astype(jnp.float32)

        def fwd_body(d, sigma):
            sT = in_table(sigma)
            contrib = jnp.where(in_valid & (lT_in[ccol_safe] == d - 1),
                                sT[ccol_safe], 0.0)
            s = row_reduce_sorted(contrib, crow, op="sum")
            return jnp.where(labels == d, s, sigma)

        sigma = jax.lax.fori_loop(1, depth + 1, fwd_body, sigma)

        # sigma static in phase 3: exchange once over out-edges
        sT_out = out_table(sigma)

        # ---- phase 3: backward delta sweep
        # (pvary: constant-initialized carries must be marked
        # device-varying for the loop VMA check under shard_map)
        delta = pvary(jnp.zeros((S,), jnp.float32), axis)

        def bwd_body(i, delta):
            d = depth - 1 - i
            dT = out_table(delta)
            nbr_ok = out_valid & (lT_out[col_safe] == d + 1)
            ratio = jnp.where(nbr_ok,
                              (1.0 + dT[col_safe]) /
                              jnp.maximum(sT_out[col_safe], 1e-30), 0.0)
            acc = row_reduce_sorted(ratio, row, op="sum")
            return jnp.where(labels == d, sigma * acc, delta)

        delta = jax.lax.fori_loop(0, jnp.maximum(depth, 0), bwd_body, delta)
        bc = jnp.where(labels > 0, delta, 0.0)
        return bc, sigma, labels, depth

    in_specs = (P(AXIS, None), P(AXIS, None), P(AXIS, None), P(AXIS, None),
                P(AXIS, None, None), P(AXIS, None, None), P())
    out_specs = (P(AXIS), P(AXIS), P(AXIS), P())
    return jax.jit(jax.shard_map(shard_fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs))


def bc_sharded_device(pg: PartitionedGraph, src_new: int, *,
                      mesh: Optional[Mesh] = None, comm_latency: int = 0):
    if not pg.has_ghosts:
        raise ValueError("sharded BC needs partition(with_ghosts=True)")
    if mesh is None:
        mesh = make_mesh(pg.num_shards)
    fn = _make_bc_fn(pg, comm_latency=comm_latency, axis=AXIS, mesh=mesh)
    return fn(pg.row_offsets, pg.col_local, pg.csc_offsets,
              pg.csc_local, pg.ghost_send_idx, pg.fwd_ghost_send_idx,
              jnp.int32(src_new))


def bc_sharded(graph: CsrGraph, src: Union[int, str] = 0, *,
               num_shards: int = None, partition_method: str = "random",
               seed: int = 0, mesh: Optional[Mesh] = None) -> ShardedBcResult:
    timer = Timer()
    if mesh is None:
        mesh = make_mesh(num_shards)
    num_shards = mesh.devices.size
    if src == "largestdegree":
        src = graph.largest_degree_vertex()
    src = int(src)
    if not 0 <= src < graph.num_nodes:
        raise ValueError(f"src {src} out of range [0, {graph.num_nodes})")

    with timer.time("partition_ms"):
        pg, perm = partition(graph, num_shards, method=partition_method,
                             seed=seed, with_csc=True, with_ghosts=True)

    with timer.time("process_ms"):
        bc_new, sigma_new, labels_new, depth = jax.block_until_ready(
            bc_sharded_device(pg, int(perm[src]), mesh=mesh))

    bc = (np.asarray(bc_new)[perm] * 0.5).astype(np.float32)
    info = make_info(
        primitive="bc_sharded", graph=graph, timer=timer,
        edges_visited=2 * graph.num_edges,
        extra={"src": src, "num_shards": int(num_shards),
               "search_depth": int(depth),
               "partition_method": partition_method,
               "ghost_cap": int(pg.ghost_cap),
               "comm_bytes_per_superstep":
                   num_shards * (num_shards - 1) * pg.ghost_cap * 4},
    )
    return ShardedBcResult(
        bc_values=bc,
        sigmas=np.asarray(sigma_new)[perm],
        labels=np.asarray(labels_new)[perm],
        info=info,
    )
