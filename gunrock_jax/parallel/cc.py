"""Multi-chip Connected Components: Shiloach–Vishkin-style min-label
hooking + pointer jumping over a vertex-sharded mesh.

The reference CC (``gunrock/app/cc/cc_enactor.cuh``, Soman hooking +
pointer jumping as filter-only edge-list iterations) becomes, per
superstep on each shard:

  1. boundary-only exchange of component ids (``ghost_exchange`` —
     O(ghosts) on NVLink; the reference ships boundary
     vertex-associates, ``enactor_helper.cuh:297-405``)
  2. hook: comp[u] <- min(comp[u], min over out-neighbors comp[v])
     — one sorted segmented min over the local CSR rows
  3. local pointer jumping: comm-free full collapse through locally
     owned representatives (remote representatives resolve across
     supersteps via min-propagation over boundary edges; superstep
     count is bounded by the diameter of the cross-shard component
     contraction, typically a handful)

Termination: ``psum`` of per-shard change counts == 0 (``All_Done``,
``enactor_helper.cuh:36``). Requires the symmetrized (undirected) graph,
same as the reference's CC.
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

__all__ = ["cc_sharded", "cc_sharded_device", "ShardedCcResult"]


@dataclasses.dataclass
class ShardedCcResult:
    components: np.ndarray
    num_components: int
    info: dict


def _make_cc_fn(pg: PartitionedGraph, *, comm_latency: int, axis: str,
                mesh: Mesh):
    S = pg.shard_size
    p = pg.num_shards
    G = pg.fwd_ghost_cap

    def shard_fn(row, col_local, send_idx, vmask, max_iters):
        row = row.reshape(-1)            # (S+1,)
        col_local = col_local.reshape(-1)  # (E_shard,) local-table dst ids
        send_idx = send_idx.reshape(p, G)
        vmask = vmask.reshape(-1)        # (S,) real-vertex mask
        my_base = jax.lax.axis_index(axis).astype(jnp.int32) * S

        lane = jnp.arange(col_local.shape[0], dtype=jnp.int32)
        evalid = lane < row[-1]
        col_safe = jnp.where(evalid, col_local, 0)

        vid = my_base + jnp.arange(S, dtype=jnp.int32)
        comp0 = jnp.where(vmask, vid, jnp.int32(0x7FFFFFFF))

        def local_collapse(comp):
            """Pointer-jump through LOCALLY-owned representatives until
            stable (no collectives: each shard collapses independently).
            Remote representatives stay as-is; min-propagation through
            boundary edges handles them across supersteps."""
            def cond(c):
                comp, changed = c
                return changed

            def body(c):
                comp, _ = c
                tgt = comp - my_base
                islocal = (tgt >= 0) & (tgt < S)
                j = jnp.where(islocal, comp[jnp.clip(tgt, 0, S - 1)], comp)
                j = jnp.minimum(comp, j)
                return j, jnp.any(j != comp)

            from .mesh import pvary
            comp, _ = jax.lax.while_loop(
                cond, body, (comp, pvary(jnp.bool_(True), axis)))
            return comp

        def global_collapse(comp):
            """Pointer-jump through a full all-gathered representative
            snapshot: cross-shard trees collapse to their snapshot roots,
            keeping superstep count polylogarithmic on high-diameter
            graphs where boundary-only min-propagation would otherwise
            cross one boundary edge per superstep. O(V) comm, run every
            GLOBAL_EVERY supersteps only."""
            from .mesh import pvary
            g = jax.lax.all_gather(comp, axis, tiled=True)   # (p*S,)

            def cond(c):
                _, changed = c
                return changed

            def body(c):
                comp, _ = c
                j = jnp.minimum(comp, g[jnp.clip(comp, 0, p * S - 1)])
                return j, jnp.any(j != comp)

            comp, _ = jax.lax.while_loop(
                cond, body, (comp, pvary(jnp.bool_(True), axis)))
            return comp

        GLOBAL_EVERY = 8

        def cond(carry):
            comp, changed, it = carry
            return (changed > 0) & (it < max_iters)

        def body(carry):
            comp, _, it = carry
            # Boundary-only exchange of component ids (the reference ships
            # vertex-associates for boundary vertices only,
            # enactor_helper.cuh:297-405) — O(ghosts) on the
            # interconnect, not O(V).
            table = ghost_exchange(axis, comp, send_idx,
                                   comm_latency=comm_latency)
            # Hook: min over out-neighbors' components.
            nbr = jnp.where(evalid, table[col_safe], jnp.int32(0x7FFFFFFF))
            m = row_reduce_sorted(nbr, row, op="min")
            hooked = jnp.minimum(comp, m)
            # Local pointer jumping (full collapse, comm-free), plus a
            # periodic global collapse rung for cross-shard chains.
            jumped = local_collapse(hooked)
            jumped = jax.lax.cond(
                (it % GLOBAL_EVERY) == GLOBAL_EVERY - 1,
                global_collapse, lambda c: c, jumped)
            changed_local = jnp.sum((jumped != comp).astype(jnp.int32))
            changed = jax.lax.psum(changed_local, axis)
            return jumped, changed, it + 1

        comp, _, iters = jax.lax.while_loop(
            cond, body, (comp0, jnp.int32(1), jnp.int32(0)))
        return comp, iters

    in_specs = (P(AXIS, None), P(AXIS, None), P(AXIS, None, None), P(AXIS),
                P())
    out_specs = (P(AXIS), P())
    return jax.jit(jax.shard_map(shard_fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs))


def cc_sharded_device(pg: PartitionedGraph, *, mesh: Optional[Mesh] = None,
                      vmask_new: jax.Array, max_iters: Optional[int] = None,
                      comm_latency: int = 0):
    if not pg.has_ghosts:
        raise ValueError("sharded CC needs partition(with_ghosts=True)")
    if mesh is None:
        mesh = make_mesh(pg.num_shards)
    if max_iters is None:
        # min-label propagation crosses >= one boundary edge per superstep
        # (local collapse is free); bound by vertices, converge by psum.
        max_iters = pg.num_nodes + 16
    fn = _make_cc_fn(pg, comm_latency=comm_latency, axis=AXIS, mesh=mesh)
    return fn(pg.row_offsets, pg.col_local, pg.fwd_ghost_send_idx,
              vmask_new.reshape(pg.num_shards, pg.shard_size),
              jnp.int32(max_iters))


def cc_sharded(graph: CsrGraph, *, num_shards: int = None,
               partition_method: str = "random", seed: int = 0,
               mesh: Optional[Mesh] = None,
               comm_latency: int = 0) -> ShardedCcResult:
    """Partition + run CC across the mesh; components labeled by the
    minimum original vertex id present in each component."""
    timer = Timer()
    if mesh is None:
        mesh = make_mesh(num_shards)
    num_shards = mesh.devices.size

    with timer.time("partition_ms"):
        pg, perm = partition(graph, num_shards, method=partition_method,
                             seed=seed, with_ghosts=True)
        vmask = np.zeros(pg.v_global_pad, bool)
        vmask[perm] = True

    with timer.time("process_ms"):
        comp_new, iters = jax.block_until_ready(
            cc_sharded_device(pg, mesh=mesh, vmask_new=jnp.asarray(vmask),
                              comm_latency=comm_latency))

    # Back to original ids: component representative = min ORIGINAL id.
    comp_old = np.asarray(comp_new)[perm]          # rep in relabeled space
    inv = np.zeros(pg.v_global_pad, np.int64)
    inv[perm] = np.arange(graph.num_nodes)
    rep_old = inv[comp_old]                        # rep as original id
    # Normalize: representative = min original id within each component.
    mins = np.full(graph.num_nodes, np.iinfo(np.int64).max)
    np.minimum.at(mins, rep_old, np.arange(graph.num_nodes))
    comp = mins[rep_old].astype(np.int32)
    num_components = int(np.unique(comp).size)
    info = make_info(
        primitive="cc_sharded", graph=graph, timer=timer,
        edges_visited=graph.num_edges * int(iters),
        extra={"num_shards": int(num_shards),
               "num_components": num_components,
               "num_iterations": int(iters),
               "partition_method": partition_method,
               "ghost_cap": int(pg.fwd_ghost_cap),
               "comm_bytes_per_superstep":
                   num_shards * (num_shards - 1) * pg.fwd_ghost_cap * 4,
               "comm_latency_rounds": comm_latency},
    )
    return ShardedCcResult(components=comp, num_components=num_components,
                           info=info)
