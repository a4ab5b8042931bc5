"""Multi-chip BFS: vertex-sharded BSP supersteps over a device mesh,
with direction optimization.

The JAX rebuild of the reference's multi-GPU BFS
(``gunrock/app/bfs/bfs_enactor.cuh`` BFSThread per GPU +
``enactor_loop.cuh`` stage machine). Each superstep is either

  push:  local advance -> bucket by owner -> all-to-all -> merge
  pull:  all-gather frontier bitmask (V/32 words) -> local CSC scan

run under ``jax.shard_map`` with the whole traversal in one
``lax.while_loop`` — termination is a ``psum`` of frontier lengths
(the reference's ``All_Done`` quiescence check,
``enactor_helper.cuh:36-79``).

Direction optimization mirrors the reference's per-GPU Beamer votes with
do_a/do_b thresholds and consensus spin
(``bfs_enactor.cuh:852-939,1829-1830``) — here the vote inputs are global
``psum`` scalars, so every shard computes the identical decision and the
consensus handshake disappears. In pull mode the frontier crosses
NVLink (an NCCL all-gather) as a packed bitmask (S/32 words per shard,
O(V) total) instead of per-owner id lists — the reference's DOBFS is
communication-bound with both comp & comm O(V_i) (doc/results.md), and
this matches that cost model.

Instrumentation: per-superstep communication bytes are accumulated in the
loop carry (reference kernel_runtime_stats duty cycles analogue) and a
``communicate_latency`` burn can be injected into the exchange for
scalability studies (reference ``--communicate-latency``,
``enactor_base.cuh:72-77``, ``util/latency_utils.cuh``).
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
    scatter_set
from ..utils.info import make_info
from ..utils.track import inject_latency
from .comm import bucket_by_owner, exchange, recv_mask
from .mesh import AXIS, make_mesh, pvary
from .partition import PartitionedGraph, partition

__all__ = ["bfs_sharded", "bfs_sharded_device", "ShardedBfsResult"]

DIR_TRACE = 512  # per-iteration direction record (1 = pull)


@dataclasses.dataclass
class ShardedBfsResult:
    labels: np.ndarray
    preds: Optional[np.ndarray]
    info: dict


def _pack_words(mask: jax.Array) -> jax.Array:
    """(S,) bool -> (S/32,) int32 packed bits, vertex-scale XLA only."""
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32)) \
        .astype(jnp.int32)
    return jnp.sum(mask.astype(jnp.int32).reshape(-1, 32) * weights[None, :],
                   axis=1, dtype=jnp.int32)


def _unpack_words(words: jax.Array) -> jax.Array:
    """(W,) int32 -> (32*W,) bool."""
    bits = (words[:, None] >> jnp.arange(32, dtype=jnp.int32)[None, :]) & 1
    return bits.reshape(-1).astype(bool)


def _push_step(pg: PartitionedGraph, *, fcap: int, out_cap: int,
               per_peer_cap: int, mark_preds: bool, axis: str,
               comm_latency: int):
    S = pg.shard_size
    p = pg.num_shards

    def step(row, col, deg, state, depth):
        labels, preds, frontier, n, m_f = state
        my = jax.lax.axis_index(axis).astype(jnp.int32)
        my_base = my * S

        # --- local advance (FullQueue_Core analogue)
        ex = _expand_csr(row, col, frontier, n, out_cap)

        # --- Make_Output: bucket boundary candidates by owner shard
        owner = ex.dst // S
        payloads = [ex.dst]
        if mark_preds:
            payloads.append(my_base + ex.src)  # global pred ids
        bufs, counts, send_ovf = bucket_by_owner(
            owner, ex.mask, payloads, num_shards=p,
            per_peer_cap=per_peer_cap)

        # --- PushNeighbor: the all-to-all over NVLink (NCCL)
        recv, rcounts = exchange(axis, bufs, counts)
        recv = [inject_latency(r, comm_latency) for r in recv]
        rmask = recv_mask(rcounts, per_peer_cap).reshape(-1)
        rdst = recv[0].reshape(-1)
        rsrc = recv[1].reshape(-1) if mark_preds else None

        # --- Expand_Incoming: merge into local labels
        lid = rdst - my_base
        safe = jnp.where(rmask, lid, 0)
        is_new = rmask & (labels[safe] == -1)
        keep = dedup_winners(safe, is_new, S)
        labels = scatter_set(labels, safe, depth, mask=keep)
        if mark_preds:
            preds = scatter_set(preds, safe, rsrc, mask=keep)
        frontier, n_local = compact(safe, keep, fcap)
        m_f_local = jnp.sum(jnp.where(keep, deg[safe], 0))

        overflow = send_ovf | (ex.total > out_cap) | (n_local > fcap)
        # bytes sent this superstep: ids (+preds) actually enqueued
        sent = jnp.sum(counts) * (8 if mark_preds else 4)
        return (labels, preds, frontier, n_local, m_f_local), ex.total, \
            overflow, sent

    return step


def _pull_frontier_words(labels, depth, axis: str, comm_latency: int):
    """Frontier -> packed local bitmask -> all-gather (the reference's
    backward frontier_map over the inverse CSR,
    oprtr/advance/kernel.cuh:355-379, exchanged as O(V/32) words)."""
    words = _pack_words(labels == depth - 1)
    gwords = jax.lax.all_gather(words, axis, tiled=True)  # (p*S/32,)
    return inject_latency(gwords, comm_latency)


def _pull_finish(state, reached, deg, csc_row, depth, p: int, S: int,
                 pred_cand=None):
    """Shared tail of both pull supersteps: label the newly reached
    vertices, emit local counters + byte accounting. The frontier queue
    is left stale; push rebuilds it lazily from labels."""
    labels, preds, frontier, n, m_f = state
    new_mask = (labels == -1) & reached
    labels = jnp.where(new_mask, depth, labels)
    if pred_cand is not None:
        # vertex-associate fill for pull-discovered vertices: the first
        # frontier in-neighbor (global id), computed on device — the
        # reference ships preds with Make_Output/Expand_Incoming
        # (app/enactor_kernel.cuh:343-433); pull mode derives them from
        # the already-gathered frontier bitmask instead.
        preds = jnp.where(new_mask, pred_cand, preds)
    n_local = jnp.sum(new_mask.astype(jnp.int32))
    m_f_local = jnp.sum(jnp.where(new_mask, deg, 0))
    edges = csc_row[-1]
    sent = jnp.int32((p - 1) * (S // 32) * 4)
    return (labels, preds, frontier, n_local, m_f_local), edges, \
        jnp.bool_(False), sent


def _first_hit_parent(run0, samples, csc_col):
    """Parent candidate per local vertex: the FIRST in-edge whose source
    is in the frontier. Row v's first hit sits where the running hit
    count first exceeds samples[v]; rows without hits yield garbage that
    ``reached`` masks off."""
    firstpos = jnp.searchsorted(run0, samples[:-1] + 1) - 1
    e = csc_col.shape[0]
    return jnp.take(csc_col, jnp.clip(firstpos, 0, e - 1))


def _pull_step(pg: PartitionedGraph, *, axis: str, comm_latency: int,
               mark_preds: bool = False):
    S = pg.shard_size
    p = pg.num_shards

    def step(csc_row, csc_col, deg, state, depth):
        labels = state[0]
        gwords = _pull_frontier_words(labels, depth, axis, comm_latency)
        fbool = _unpack_words(gwords)                         # (p*S,) bool

        # reached(v) = any in-neighbor in the frontier: cumsum-boundary
        # trick over the local CSC (models/bfs._pull_step shape).
        hit = fbool[csc_col].astype(jnp.int32)
        run = jnp.cumsum(hit)
        run0 = jnp.concatenate([jnp.zeros((1,), jnp.int32), run])
        samples = jnp.take(run0, csc_row, indices_are_sorted=True)
        reached = (samples[1:] - samples[:-1]) > 0
        pred_cand = _first_hit_parent(run0, samples, csc_col) \
            if mark_preds else None
        return _pull_finish(state, reached, deg, csc_row, depth, p, S,
                            pred_cand)

    return step


def _make_bfs_fn(pg: PartitionedGraph, *, fcap: int, out_cap: int,
                 per_peer_cap: int, mark_preds: bool,
                 direction_optimized: bool, alpha: float, beta: float,
                 comm_latency: int, axis: str, mesh: Mesh):
    S = pg.shard_size
    p = pg.num_shards
    push = _push_step(pg, fcap=fcap, out_cap=out_cap,
                      per_peer_cap=per_peer_cap, mark_preds=mark_preds,
                      axis=axis, comm_latency=comm_latency)
    pull = _pull_step(pg, axis=axis, comm_latency=comm_latency,
                      mark_preds=mark_preds) if direction_optimized else None

    def shard_fn(row, col, csc_row, csc_col, src_new, max_iters):
        row = row.reshape(-1)          # (S+1,)
        col = col.reshape(-1)          # (E_shard,)
        deg = row[1:] - row[:-1]       # (S,) local out-degrees
        if direction_optimized:
            csc_row = csc_row.reshape(-1)
            csc_col = csc_col.reshape(-1)
        my = jax.lax.axis_index(axis).astype(jnp.int32)
        my_base = my * S
        owns_src = (src_new >= my_base) & (src_new < my_base + S)
        lsrc = jnp.where(owns_src, src_new - my_base, 0)

        lane = jnp.arange(S, dtype=jnp.int32)
        labels = jnp.where(owns_src & (lane == lsrc), 0, -1).astype(jnp.int32)
        preds = (jnp.full((S,), -1, jnp.int32) if mark_preds
                 else jnp.zeros((1,), jnp.int32))
        # Constant-initialized carries must be marked device-varying for
        # the while_loop VMA check under shard_map.
        preds = pvary(preds, axis)
        frontier = jnp.zeros((fcap,), jnp.int32).at[0].set(lsrc)
        n = jnp.where(owns_src, 1, 0).astype(jnp.int32)
        m_f0 = jnp.where(owns_src, deg[lsrc], 0)
        dir_trace = pvary(jnp.full((DIR_TRACE,), -1, jnp.int32), axis)

        def cond(carry):
            (state, it, edges, ovf, use_pull, unexplored, bytes_comm,
             trace, fvalid, n_global) = carry
            return (n_global > 0) & (it < max_iters) & (~ovf)

        def body(carry):
            (state, it, edges, ovf, use_pull, unexplored, bytes_comm,
             trace, fvalid, n_global) = carry
            labels, preds, frontier, n, m_f = state
            depth = it + 1
            m_f_global = jax.lax.psum(m_f, axis).astype(jnp.float32)

            if direction_optimized:
                # Beamer vote on global scalars — identical on every
                # shard, no consensus spin needed (cf. the reference's
                # per-GPU vote + wait, bfs_enactor.cuh:909-914).
                to_pull = m_f_global * jnp.float32(alpha) > unexplored
                to_push = n_global.astype(jnp.float32) * jnp.float32(beta) \
                    < jnp.float32(pg.num_nodes)
                pick_pull = jnp.where(use_pull, ~to_push, to_pull)

                def do_push(st):
                    labels, preds, frontier, n, m_f = st
                    # lazy queue rebuild after pull iterations
                    frontier, n = jax.lax.cond(
                        fvalid, lambda: (frontier, n),
                        lambda: frontier_from_mask(labels == depth - 1,
                                                   fcap))
                    # A rebuilt frontier can exceed fcap when
                    # queue_sizing < 1: clamp AND surface the truncation
                    # so the sizing retry loop engages (the single-chip
                    # path's rebuild_ovf guard, models/bfs.py).
                    rebuild_ovf = n > fcap
                    n = jnp.minimum(n, fcap)
                    st2, e_it, ovf_p, sent = push(
                        row, col, deg,
                        (labels, preds, frontier, n, m_f), depth)
                    return st2, e_it, ovf_p | rebuild_ovf, sent

                vary = lambda t: jax.tree.map(lambda x: pvary(x, axis), t)
                new_state, e_it, overflow, sent = jax.lax.cond(
                    pick_pull,
                    lambda st: vary(pull(csc_row, csc_col, deg, st, depth)),
                    lambda st: vary(do_push(st)), state)
                fvalid2 = ~pick_pull
            else:
                new_state, e_it, overflow, sent = push(
                    row, col, deg, state, depth)
                pick_pull = jnp.bool_(False)
                fvalid2 = jnp.bool_(True)

            n_global2 = jax.lax.psum(new_state[3], axis)
            ovf2 = ovf | (jax.lax.psum(overflow.astype(jnp.int32), axis) > 0)
            bytes_comm = bytes_comm + jax.lax.psum(
                sent.astype(jnp.float32), axis)
            trace = trace.at[jnp.minimum(it, DIR_TRACE - 1)].set(
                pick_pull.astype(jnp.int32))
            out = (new_state, it + 1, edges + e_it.astype(jnp.float32),
                   ovf2, pick_pull, unexplored - m_f_global, bytes_comm,
                   trace, fvalid2, n_global2)
            # psum outputs and branch constants are axis-invariant; keep
            # the carry uniformly varying for the while_loop VMA check
            return jax.tree.map(lambda x: pvary(x, axis), out)

        state0 = (labels, preds, frontier, n, m_f0)
        init = (state0, jnp.int32(0), jnp.float32(0), jnp.bool_(False),
                jnp.bool_(False), jnp.float32(pg.num_edges),
                jnp.float32(0), dir_trace, jnp.bool_(True), jnp.int32(1))
        # constant-initialized carries become device-varying in the body
        init = jax.tree.map(lambda x: pvary(x, axis), init)
        (final, iters, edges, ovf, _, _, bytes_comm, trace, _, _) = \
            jax.lax.while_loop(cond, body, init)
        labels, preds, _, _, _ = final
        # scalar outputs are identical on every shard but typed varying;
        # pmax re-establishes the replication proof for P() out_specs
        inv = lambda x: jax.lax.pmax(x.astype(jnp.int32)
                                     if x.dtype == jnp.bool_ else x, axis)
        return (labels, preds, inv(iters), inv(edges),
                inv(ovf).astype(jnp.bool_), inv(bytes_comm), inv(trace))

    in_specs = (P(AXIS, None), P(AXIS, None), P(AXIS, None), P(AXIS, None),
                P(), P())
    out_specs = (P(AXIS), P(AXIS), P(), P(), P(), P(), P())
    return jax.jit(jax.shard_map(shard_fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs))


def bfs_sharded_device(pg: PartitionedGraph, src_new: int, *,
                       mesh: Optional[Mesh] = None,
                       mark_preds: bool = False,
                       direction_optimized: bool = False,
                       alpha: float = 15.0, beta: float = 18.0,
                       comm_latency: int = 0,
                       queue_sizing: float = 1.0,
                       in_sizing: float = 1.0,
                       max_iters: Optional[int] = None):
    """Run sharded BFS in relabeled id space; returns device arrays
    (labels over p*S relabeled vertices, preds, iters, edges, overflow,
    comm_bytes, direction trace)."""
    if mesh is None:
        mesh = make_mesh(pg.num_shards)
    if direction_optimized and pg.csc_offsets is None:
        raise ValueError(
            "direction-optimized sharded BFS needs partition(with_csc=True)")
    fcap = max(128, int(pg.shard_size * min(queue_sizing, 1.0)))
    out_cap = max(128, int(pg.e_shard_pad * min(queue_sizing, 1.0)))
    per_peer_cap = max(128, int(out_cap * min(in_sizing, 1.0)))
    if max_iters is None:
        max_iters = pg.num_nodes + 1
    fn = _make_bfs_fn(pg, fcap=fcap, out_cap=out_cap,
                      per_peer_cap=per_peer_cap, mark_preds=mark_preds,
                      direction_optimized=direction_optimized,
                      alpha=alpha, beta=beta, comm_latency=comm_latency,
                      axis=AXIS, mesh=mesh)
    zero = jnp.zeros((pg.num_shards, 1), jnp.int32)
    csc_row = pg.csc_offsets if pg.csc_offsets is not None else zero
    csc_col = pg.csc_indices if pg.csc_indices is not None else zero
    return fn(pg.row_offsets, pg.col_indices, csc_row, csc_col,
              jnp.int32(src_new), jnp.int32(max_iters))


def bfs_sharded(graph: CsrGraph, src: int = 0, *, num_shards: int = None,
                partition_method: str = "random", seed: int = 0,
                mark_preds: bool = False,
                direction_optimized: bool = False,
                alpha: float = 15.0, beta: float = 18.0,
                comm_latency: int = 0,
                mesh: Optional[Mesh] = None,
                queue_sizing: float = 1.0, in_sizing: float = 1.0,
                max_iters: Optional[int] = None) -> ShardedBfsResult:
    """Partition ``graph`` and run BFS across the mesh; returns results in
    original vertex ids (the reference's Extract stitches sub-GPU results
    via ``original_vertex`` tables, ``bfs_problem.cuh:518``)."""
    timer = Timer()
    if mesh is None:
        mesh = make_mesh(num_shards)
    num_shards = mesh.devices.size
    if not 0 <= int(src) < graph.num_nodes:
        raise ValueError(f"src {src} out of range [0, {graph.num_nodes})")

    with timer.time("partition_ms"):
        pg, perm = partition(graph, num_shards, method=partition_method,
                             seed=seed, with_csc=direction_optimized)
    with timer.time("process_ms"):
        # Overflow auto-retry with doubled sizing (reference Check_Size
        # regrow, enactor_helper.cuh:103-138): sizing 1.0 is provably
        # sufficient (frontier <= S locals, advance output <= local edges,
        # per-peer receive <= sender's out edges), so this terminates with
        # complete results — never partial labels.
        qs, ins = queue_sizing, in_sizing
        while True:
            labels, preds, iters, edges, ovf, comm_bytes, trace = \
                jax.block_until_ready(bfs_sharded_device(
                    pg, int(perm[src]), mesh=mesh, mark_preds=mark_preds,
                    direction_optimized=direction_optimized, alpha=alpha,
                    beta=beta, comm_latency=comm_latency, queue_sizing=qs,
                    in_sizing=ins, max_iters=max_iters))
            if not bool(ovf) or (qs >= 1.0 and ins >= 1.0):
                break
            qs = min(qs * 2.0, 1.0)
            ins = min(ins * 2.0, 1.0)

    labels_new = np.asarray(labels)
    labels_old = labels_new[perm]
    preds_old = None
    if mark_preds:
        inv = np.full(pg.v_global_pad, -1, np.int64)
        inv[perm] = np.arange(graph.num_nodes)
        preds_new = np.asarray(preds)[perm]
        preds_old = np.where(preds_new >= 0, inv[np.maximum(preds_new, 0)],
                             -1).astype(np.int32)

    trace_np = np.asarray(trace)
    it = int(iters)
    degs = np.diff(graph.row_offsets).astype(np.int64)
    info = make_info(
        primitive="bfs_sharded", graph=graph, timer=timer,
        edges_visited=int(degs[labels_old >= 0].sum()),
        extra={"src": int(src), "num_shards": int(num_shards),
               "partition_method": partition_method,
               "num_iterations": it,
               "frontier_overflow": bool(ovf),
               "direction_optimized": direction_optimized,
               "direction_trace": trace_np[:min(it, DIR_TRACE)].tolist(),
               "pull_iterations": int((trace_np[:it] == 1).sum()),
               "comm_bytes": float(comm_bytes),
               "comm_latency_rounds": comm_latency,
               "search_depth": int(labels_old.max(initial=0))},
    )
    return ShardedBfsResult(labels=labels_old, preds=preds_old, info=info)
