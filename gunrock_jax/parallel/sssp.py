"""Multi-chip SSSP: sharded relaxation supersteps with distance
associates and near-far delta-stepping.

Mirrors the reference's multi-GPU SSSP which exchanges distances as
value-associates with boundary vertices each superstep
(``app/sssp/sssp_enactor.cuh:666``):

  push:  local relax -> bucket (dst, cand) pairs by owner -> all-to-all
         -> scatter-min merge

Scheduling modes match the single-chip zoo (``models/sssp.py``):
``bellman`` relaxes every improved vertex next round; ``nearfar`` keeps
a two-level near/far pile (``gunrock/priority_queue/near_far_pile.cuh``)
— here the threshold-advance "Bisect" is one global ``pmin`` over active
distances (every shard computes the identical new level; no spin).
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
from ..ops.advance import _expand_csr
from ..ops.segment import compact, dedup_winners, frontier_from_mask, \
    scatter_min, scatter_set
from ..utils.info import make_info
from .comm import bucket_by_owner, exchange, recv_mask
from .mesh import AXIS, make_mesh, pvary
from .partition import PartitionedGraph, partition

__all__ = ["sssp_sharded", "sssp_sharded_device", "ShardedSsspResult"]

INF = np.float32(np.inf)


@dataclasses.dataclass
class ShardedSsspResult:
    distances: np.ndarray
    info: dict


def _make_sssp_fn(pg: PartitionedGraph, *, fcap: int, out_cap: int,
                  per_peer_cap: int, axis: str, mesh: Mesh,
                  mode: str = "bellman", delta: float = 1.0):
    S = pg.shard_size
    p = pg.num_shards
    nearfar = mode == "nearfar"

    def shard_fn(row, col, weights, dist, frontier, n, active,
                 level, n_global0, it0, bytes0, it_stop):
        row = row.reshape(-1)
        col = col.reshape(-1)
        weights = weights.reshape(-1)
        my = jax.lax.axis_index(axis).astype(jnp.int32)
        my_base = my * S
        n = n.reshape(())

        def push_step(dist, frontier, n):
            """Local relax -> owner-bucketed associate exchange ->
            scatter-min merge. Returns (dist, improved mask, overflow)."""
            ex = _expand_csr(row, col, frontier, n, out_cap)
            w = weights[ex.eid]
            cand = jnp.where(ex.mask, dist[ex.src] + w, INF)
            owner = ex.dst // S
            bufs, counts, send_ovf = bucket_by_owner(
                owner, ex.mask, [ex.dst, cand], num_shards=p,
                per_peer_cap=per_peer_cap)
            recv, rcounts = exchange(axis, bufs, counts)
            rmask = recv_mask(rcounts, per_peer_cap).reshape(-1)
            lid = recv[0].reshape(-1) - my_base
            rcand = recv[1].reshape(-1)
            safe = jnp.where(rmask, lid, 0)
            old = dist[safe]
            new_dist = scatter_min(dist, safe,
                                   jnp.where(rmask, rcand, INF),
                                   mask=rmask)
            improved_lanes = rmask & (rcand < old)
            win = dedup_winners(safe, improved_lanes, S)
            imp = jnp.zeros((S,), jnp.bool_)
            imp = scatter_set(imp, safe, jnp.ones_like(win), mask=win)
            ovf = send_ovf | (ex.total > out_cap)
            sent = jnp.sum(counts) * 8
            return new_dist, imp, ovf, sent

        def cond(carry):
            _, _, _, _, _, n_global, it, ovf, _ = carry
            return (n_global > 0) & (it < it_stop) & (~ovf)

        def body(carry):
            (dist, frontier, n, active, level, n_global, it, ovf,
             bytes_comm) = carry
            dist, imp, step_ovf, sent = push_step(dist, frontier, n)

            if nearfar:
                # Improved vertices enter the pile; near bucket = below
                # the threshold. Empty bucket -> jump the level straight
                # past the global min active distance (one pmin replaces
                # the reference's Bisect re-split spin).
                active = active | imp
                near = active & (dist < level)
                any_near = jax.lax.psum(
                    jnp.sum(near.astype(jnp.int32)), axis) > 0
                gmin = jax.lax.pmin(
                    jnp.min(jnp.where(active, dist, INF)), axis)
                new_level = delta * (jnp.floor(gmin / delta) + 1.0)
                # float32 guard: the advanced threshold must clear gmin
                # STRICTLY (near uses dist < level), or the near bucket
                # stays empty and the loop exits with active vertices
                # unprocessed — the single-chip _bisect loops until near
                # is nonempty and can't exit early.
                new_level = jnp.where(new_level > gmin, new_level,
                                      jnp.nextafter(gmin, INF))
                new_level = jnp.where(jnp.isfinite(gmin), new_level,
                                      level)
                level = jnp.where(any_near, level, new_level)
                near = active & (dist < level)
                active = active & ~near
            else:
                near = imp

            frontier, n_local = frontier_from_mask(near, fcap)
            rebuild_ovf = n_local > fcap
            n_local = jnp.minimum(n_local, fcap)
            n_global = jax.lax.psum(n_local, axis)
            ovf = ovf | (jax.lax.psum(
                (step_ovf | rebuild_ovf).astype(jnp.int32), axis) > 0)
            bytes_comm = bytes_comm + jax.lax.psum(
                sent.astype(jnp.float32), axis)
            out = (dist, frontier, n_local, active, level, n_global,
                   it + 1, ovf, bytes_comm)
            # psum/pmin outputs and branch constants are axis-invariant;
            # keep the carry uniformly varying for the VMA check
            return jax.tree.map(lambda x: pvary(x, axis), out)

        init = (dist, frontier, n, active, level, n_global0, it0,
                jnp.bool_(False), bytes0)
        init = jax.tree.map(lambda x: pvary(x, axis), init)
        (dist, frontier, n, active, level, n_global, iters, ovf,
         bytes_comm) = jax.lax.while_loop(cond, body, init)
        # scalar outputs are identical on every shard but typed varying;
        # pmax re-establishes the replication proof for P() out_specs
        inv = lambda x: jax.lax.pmax(x.astype(jnp.float32)
                                     if x.dtype == jnp.bool_
                                     else x, axis)
        return (dist, frontier, n.reshape(1), active, inv(level),
                inv(n_global), inv(iters), inv(ovf) > 0, inv(bytes_comm))

    in_specs = (P(AXIS, None), P(AXIS, None), P(AXIS, None),
                P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(), P(), P(), P(),
                P())
    out_specs = (P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(), P(), P(), P(),
                 P())
    return jax.jit(jax.shard_map(shard_fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs))


def sssp_sharded_device(pg: PartitionedGraph, src_new: int, *,
                        mesh: Optional[Mesh] = None,
                        queue_sizing: float = 1.0, in_sizing: float = 1.0,
                        max_iters: Optional[int] = None,
                        mode: str = "bellman", delta: float = 1.0):
    if pg.edge_values is None:
        raise ValueError("sharded SSSP needs partition(with_edge_values=True)")
    if mode not in ("bellman", "nearfar"):
        raise ValueError(f"unknown sssp mode {mode!r}")
    if mesh is None:
        mesh = make_mesh(pg.num_shards)
    fcap = max(128, int(pg.shard_size * min(queue_sizing, 1.0)))
    out_cap = max(128, int(pg.e_shard_pad * min(queue_sizing, 1.0)))
    per_peer_cap = max(128, int(out_cap * min(in_sizing, 1.0)))
    if max_iters is None:
        max_iters = 4 * pg.num_nodes + 16
    fn = _make_sssp_fn(pg, fcap=fcap, out_cap=out_cap,
                       per_peer_cap=per_peer_cap, axis=AXIS, mesh=mesh,
                       mode=mode, delta=float(delta))
    gargs = [pg.row_offsets, pg.col_indices, pg.edge_values]

    # Host-side initial state: the source's owner shard holds the lone
    # frontier entry.
    S, p = pg.shard_size, pg.num_shards
    owner = int(src_new) // S
    dist = np.full((p * S,), np.inf, np.float32)
    dist[int(src_new)] = 0.0
    frontier = np.zeros((p * fcap,), np.int32)
    frontier[owner * fcap] = int(src_new) - owner * S
    n = np.zeros((p,), np.int32)
    n[owner] = 1
    active = np.zeros((p * S,), np.bool_)
    level = np.float32(delta if mode == "nearfar" else np.inf)
    state = (jnp.asarray(dist), jnp.asarray(frontier), jnp.asarray(n),
             jnp.asarray(active), jnp.asarray(level), jnp.int32(1),
             jnp.int32(0), jnp.float32(0))

    # Chunked enactment (single-chip models/sssp.py parity): bound each
    # device dispatch by rounds*out_cap edge-lanes so deep traversals
    # (thousands of near-far rounds) run as several bounded calls.
    chunk = max(16, min(512, (1 << 31) // max(out_cap, 1)))
    while True:
        it0 = int(state[6])
        it_stop = jnp.int32(min(it0 + chunk, max_iters))
        out = fn(*(gargs + list(state) + [it_stop]))
        # out = (dist, frontier, n, active, level, n_global, it, ovf,
        #        bytes); resume state excludes ovf (sticky via retry).
        state, ovf = out[:7] + (out[8],), out[7]
        n_global, iters = int(state[5]), int(state[6])
        if n_global == 0 or bool(ovf) or iters >= max_iters:
            break
    return state[0], state[6], ovf, state[7]


def sssp_sharded(graph: CsrGraph, src: int = 0, *, num_shards: int = None,
                 partition_method: str = "random", seed: int = 0,
                 mesh: Optional[Mesh] = None, queue_sizing: float = 1.0,
                 in_sizing: float = 1.0,
                 max_iters: Optional[int] = None,
                 mode: str = "bellman",
                 delta_factor: int = 32) -> ShardedSsspResult:
    """Partition ``graph`` and run SSSP across the mesh.

    ``mode='nearfar'`` enables sharded delta-stepping with
    ``delta = delta_factor * mean(edge weight)`` (the C API knob,
    ``gunrock/gunrock.h:98``)."""
    timer = Timer()
    if mesh is None:
        mesh = make_mesh(num_shards)
    num_shards = mesh.devices.size
    if not 0 <= int(src) < graph.num_nodes:
        raise ValueError(f"src {src} out of range [0, {graph.num_nodes})")
    if graph.edge_values is None:
        graph.random_edge_values()
    delta = float(delta_factor) * float(np.mean(graph.edge_values)) \
        if mode == "nearfar" else 1.0

    with timer.time("partition_ms"):
        pg, perm = partition(graph, num_shards, method=partition_method,
                             seed=seed, with_edge_values=True)
    with timer.time("process_ms"):
        # Overflow auto-retry with doubled sizing (reference Check_Size
        # regrow, enactor_helper.cuh:103-138); sizing 1.0 cannot overflow.
        qs, ins = queue_sizing, in_sizing
        while True:
            dist, iters, ovf, comm_bytes = jax.block_until_ready(
                sssp_sharded_device(pg, int(perm[src]), mesh=mesh,
                                    queue_sizing=qs, in_sizing=ins,
                                    max_iters=max_iters, mode=mode,
                                    delta=delta))
            if not bool(ovf) or (qs >= 1.0 and ins >= 1.0):
                break
            qs = min(qs * 2.0, 1.0)
            ins = min(ins * 2.0, 1.0)

    dist_old = np.asarray(dist)[perm]
    degs = np.diff(graph.row_offsets).astype(np.int64)
    info = make_info(
        primitive="sssp_sharded", graph=graph, timer=timer,
        edges_visited=int(degs[np.isfinite(dist_old)].sum()),
        extra={"src": int(src), "num_shards": int(num_shards),
               "num_iterations": int(iters),
               "frontier_overflow": bool(ovf),
               "mode": mode, "delta": delta if mode == "nearfar" else None,
               "comm_bytes": float(comm_bytes),
               "partition_method": partition_method},
    )
    return ShardedSsspResult(distances=dist_old, info=info)
