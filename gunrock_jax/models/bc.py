"""Betweenness centrality (Brandes, forward + backward frontier passes).

JAX rebuild of the reference BC primitive
(``gunrock/app/bc/{bc_problem,bc_enactor,bc_functor}.cuh``): a BFS-like
forward phase accumulates per-vertex shortest-path counts ``sigma``
(atomicAdd in ``bc_functor.cuh:70-71`` -> deterministic scatter-add), then
a backward phase replays the BFS levels in reverse accumulating
dependencies ``delta[u] += sigma[u]/sigma[v] * (1 + delta[v])``
(``bc_functor.cuh:203-238``).

Where the reference stores per-iteration frontiers via
``forward_queue_offsets`` and replays them with a backward (pull) advance
over backward partition tables (``bc_enactor.cuh:1528-1870``), we sort
vertices by BFS depth once and slice per-level frontiers from the sorted
order — same replay, one argsort.

Both phases push per level through the capacity ladder. Instrumented
runs chunk-enact one level per device call (``_bc_hybrid``) to record
per-level wall clocks.

Outputs are scaled by 0.5 (undirected double-count), matching the
reference CPU validation (``tests/bc/test_bc.cu`` RefCPUBC).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..enactor import (LoopStats, Timer, capacity_ladder, dispatch_by_size,
                       init_stats, record_iteration)
from ..graph.csr import CsrGraph
from ..graph.device import DeviceGraph, to_device
from ..ops.advance import expand
from ..ops.segment import compact, dedup_winners, scatter_add, scatter_set
from ..utils.info import make_info

__all__ = ["bc", "BcResult", "bc_device"]


@dataclasses.dataclass
class BcResult:
    bc_values: np.ndarray    # (V,) float32 centrality
    sigmas: np.ndarray       # (V,) float32 shortest-path counts (last src)
    labels: np.ndarray       # (V,) int32 BFS depth (last src)
    info: dict


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["labels", "sigma", "frontier", "n", "stats"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class _FwdState:
    labels: jax.Array
    sigma: jax.Array
    frontier: jax.Array
    n: jax.Array
    stats: LoopStats


def _frontier_edges(graph, frontier, n):
    lane = jnp.arange(frontier.shape[0], dtype=jnp.int32)
    valid = lane < n
    f = jnp.where(valid, frontier, 0)
    return jnp.sum(jnp.where(
        valid, graph.row_offsets[f + 1] - graph.row_offsets[f], 0))


def _make_forward_branch(graph: DeviceGraph, fcap: int):
    def make(cap: int):
        def step(state: _FwdState):
            depth = state.stats.iteration + 1
            ex = expand(graph, state.frontier, state.n, cap)
            is_new = ex.mask & (state.labels[ex.dst] == -1)
            keep = dedup_winners(ex.dst, is_new, graph.v_pad)
            labels = scatter_set(state.labels, ex.dst, depth, mask=keep)
            # Every lane landing on a depth-`depth` vertex contributes its
            # source's path count (Forward_Iteration, bc_functor.cuh:70).
            contrib = ex.mask & (labels[ex.dst] == depth)
            sigma = scatter_add(state.sigma, ex.dst, state.sigma[ex.src],
                                mask=contrib)
            frontier, n = compact(ex.dst, keep, fcap)
            return labels, sigma, frontier, n, ex.total, ex.total > cap
        return step
    return make


def _make_fwd_step(graph: DeviceGraph, fcap: int, caps):
    """One forward level: frontier push through the capacity ladder."""
    fwd = _make_forward_branch(graph, fcap)

    def step(state: _FwdState):
        m_f = _frontier_edges(graph, state.frontier, state.n)
        labels, sigma, frontier, n, edges, overflow = dispatch_by_size(
            m_f, caps, fwd, state)
        stats = record_iteration(state.stats, frontier_len=n, edges=edges,
                                 overflow=overflow)
        return _FwdState(labels=labels, sigma=sigma, frontier=frontier,
                         n=n, stats=stats)
    return step


def _fwd_init(graph: DeviceGraph, src, fcap: int) -> _FwdState:
    v_pad = graph.v_pad
    return _FwdState(
        labels=jnp.full((v_pad,), -1, jnp.int32).at[src].set(0),
        sigma=jnp.zeros((v_pad,), jnp.float32).at[src].set(1.0),
        frontier=jnp.zeros((fcap,), jnp.int32).at[0].set(src),
        n=jnp.int32(1), stats=init_stats())


def _level_replay(labels, v_pad: int, fcap: int):
    """Vertices sorted by BFS depth + level offsets (the reference's
    forward_queue_offsets, bc_problem.cuh): one argsort replaces the
    per-iteration frontier stash."""
    BIG = jnp.int32(2**30)
    key = jnp.where(labels >= 0, labels, BIG)
    order = jnp.argsort(key).astype(jnp.int32)          # levels ascending
    sorted_key = key[order]
    # offsets[l] = first sorted index with depth >= l
    levels = jnp.arange(v_pad + 1, dtype=jnp.int32)
    offsets = jnp.searchsorted(sorted_key, levels).astype(jnp.int32)
    order_padded = jnp.concatenate([order, jnp.zeros((fcap,), jnp.int32)])
    return order_padded, offsets


def _make_bwd_step(graph: DeviceGraph, labels, sigma, order_padded,
                   offsets, fcap: int, caps):
    """One backward level over (delta, t): ladder push from the level-t
    ring."""

    def make_back(cap: int):
        def bstep(args):
            delta, t = args
            start = offsets[t]
            n = offsets[t + 1] - start
            frontier = jax.lax.dynamic_slice(order_padded, (start,),
                                             (fcap,))
            ex = expand(graph, frontier, n, cap)
            down = ex.mask & (labels[ex.dst] == t + 1)
            sig_dst = jnp.where(down, sigma[ex.dst], 1.0)
            add = jnp.where(down,
                            sigma[ex.src] / sig_dst * (1.0 + delta[ex.dst]),
                            0.0)
            delta = scatter_add(delta, ex.src, add, mask=down)
            return delta, ex.total
        return bstep

    def step(args):
        delta, t = args
        start = offsets[t]
        n = offsets[t + 1] - start
        frontier = jax.lax.dynamic_slice(order_padded, (start,), (fcap,))
        m_f = _frontier_edges(graph, frontier, n)
        delta, _ = dispatch_by_size(m_f, caps, make_back, args)
        return delta, t - 1
    return step


def _bc_loop(graph: DeviceGraph, src: jax.Array, *, fcap: int,
             caps: tuple[int, ...]):
    """Single-call Brandes — the default path, also run by the replicated
    batch execution (``parallel/replicate.bc_batch`` runs it inside
    shard_map). Instrumented runs chunk-enact the SAME step makers from
    the host (``_bc_hybrid``)."""
    v_pad = graph.v_pad
    fstep = _make_fwd_step(graph, fcap, caps)

    def fcond(state: _FwdState):
        return (state.n > 0) & (~state.stats.overflow)

    fstate = jax.lax.while_loop(fcond, fstep, _fwd_init(graph, src, fcap))
    labels, sigma = fstate.labels, fstate.sigma
    max_depth = fstate.stats.iteration  # >= deepest label

    order_padded, offsets = _level_replay(labels, v_pad, fcap)
    bstep = _make_bwd_step(graph, labels, sigma, order_padded, offsets,
                           fcap, caps)

    def bcond(args):
        return args[1] >= 0

    delta, _ = jax.lax.while_loop(
        bcond, bstep, (jnp.zeros((v_pad,), jnp.float32), max_depth - 1))
    bc_vals = jnp.where(jnp.arange(v_pad) == src, 0.0, delta)
    return bc_vals, sigma, labels, fstate.stats


_bc_jit = jax.jit(_bc_loop, static_argnames=("fcap", "caps"))


@partial(jax.jit, static_argnames=("fcap", "caps"))
def _bc_fwd_jit(graph: DeviceGraph, state: _FwdState, upto, *, fcap: int,
                caps):
    fstep = _make_fwd_step(graph, fcap, caps)

    def fcond(st: _FwdState):
        return (st.n > 0) & (~st.stats.overflow) & \
               (st.stats.iteration < upto)

    st = jax.lax.while_loop(fcond, fstep, state)
    probe = jnp.stack([st.stats.iteration,
                       st.stats.overflow.astype(jnp.int32), st.n])
    return st, probe


@partial(jax.jit, static_argnames=("fcap",))
def _bc_mid_jit(labels, *, fcap: int):
    return _level_replay(labels, labels.shape[0], fcap)


@partial(jax.jit, static_argnames=("fcap", "caps"))
def _bc_bwd_jit(graph: DeviceGraph, labels, sigma, order_padded, offsets,
                delta, t_hi, t_lo, *, fcap: int, caps):
    bstep = _make_bwd_step(graph, labels, sigma, order_padded, offsets,
                           fcap, caps)

    def bcond(args):
        return args[1] >= t_lo

    delta, _ = jax.lax.while_loop(bcond, bstep, (delta, t_hi))
    return delta


def _bc_hybrid(graph: DeviceGraph, src: int, fcap: int, caps,
               instrument=None):
    """Host-chunked enactment: bounded level counts per device call (the
    same chunking discipline as bfs_device/sssp_device). With
    ``instrument`` set, enacts one level per call and records per-level
    wall clocks for both phases."""
    import time as _time
    chunk = max(8, min(512, (1 << 27) // max(graph.e_pad, 1) * 8))
    if instrument is not None:
        chunk = 1
    st = _fwd_init(graph, jnp.int32(src), fcap)
    upto = chunk
    t0 = _time.perf_counter()
    while True:
        st, probe = _bc_fwd_jit(graph, st, jnp.int32(upto), fcap=fcap,
                                caps=caps)
        it, ovf, n = (int(x) for x in np.asarray(probe))
        if instrument is not None:
            t1 = _time.perf_counter()
            instrument.append({"phase": "forward", "level": it,
                               "ms": (t1 - t0) * 1e3, "frontier": n})
            t0 = t1
        if ovf or n == 0 or it < upto:
            break
        upto = it + chunk
    labels, sigma = st.labels, st.sigma
    max_depth = int(st.stats.iteration)
    order_padded, offsets = _bc_mid_jit(labels, fcap=fcap)
    delta = jnp.zeros((graph.v_pad,), jnp.float32)
    hi = max_depth - 1
    t0 = _time.perf_counter()
    while hi >= 0:
        lo = max(0, hi - chunk + 1)
        delta = jax.block_until_ready(_bc_bwd_jit(
            graph, labels, sigma, order_padded, offsets,
            delta, jnp.int32(hi), jnp.int32(lo), fcap=fcap, caps=caps))
        if instrument is not None:
            t1 = _time.perf_counter()
            instrument.append({"phase": "backward", "level": hi,
                               "ms": (t1 - t0) * 1e3})
            t0 = t1
        hi = lo - 1
    bc_vals = jnp.where(jnp.arange(graph.v_pad) == src, 0.0, delta)
    return bc_vals, sigma, labels, st.stats


def bc_device(graph: DeviceGraph, src, *, queue_sizing: float = 1.0,
              instrument=None):
    fcap = max(128, int(graph.v_pad * min(queue_sizing, 1.0)))
    out_cap = max(128, int(graph.e_pad * min(queue_sizing, 1.0)))
    caps = tuple(capacity_ladder(out_cap))
    if instrument is not None:
        # Chunked enactment carries --instrumented per-level records.
        return _bc_hybrid(graph, int(src), fcap, caps,
                          instrument=instrument)
    return _bc_jit(graph, jnp.int32(src), fcap=fcap, caps=caps)


def bc(graph: Union[CsrGraph, DeviceGraph],
       src: Optional[Union[int, str]] = 0, *,
       queue_sizing: float = 1.0, instrumented: bool = False) -> BcResult:
    """Betweenness centrality (C API parity: ``gunrock_bc``,
    ``gunrock.h:200``). ``src=None`` or ``-1`` accumulates over all
    sources (exact BC), matching the reference's ``--src=-1`` mode.
    ``instrumented`` collects per-level phase records."""
    timer = Timer()
    per_iter: Optional[list] = [] if instrumented else None
    num_nodes = graph.num_nodes
    if isinstance(graph, CsrGraph):
        if src == "largestdegree":
            src = graph.largest_degree_vertex()
        with timer.time("preprocess_ms"):
            dgraph = to_device(graph)
    else:
        dgraph = graph

    if src is None or src == -1:
        sources = range(num_nodes)
    else:
        src = int(src)
        if not 0 <= src < num_nodes:
            raise ValueError(f"src {src} out of range [0, {num_nodes})")
        sources = [src]

    bc_acc = np.zeros(num_nodes, np.float64)
    with timer.time("process_ms"):
        for s in sources:
            bc_vals, sigma, labels, stats = jax.block_until_ready(
                bc_device(dgraph, s, queue_sizing=queue_sizing,
                          instrument=per_iter))
            bc_acc += np.asarray(bc_vals)[:num_nodes]

    bc_np = (bc_acc * 0.5).astype(np.float32)
    info = make_info(
        primitive="bc", graph=dgraph, stats=stats, timer=timer,
        edges_visited=2 * int(stats.edges_queued) * len(list(sources)),
        extra={"src": -1 if len(list(sources)) > 1 else int(sources[0]),
               "instrumented": instrumented,
               "search_depth": int(stats.iteration),
               **({"per_iteration": per_iter} if instrumented else {})},
    )
    return BcResult(bc_values=bc_np,
                    sigmas=np.asarray(sigma)[:num_nodes],
                    labels=np.asarray(labels)[:num_nodes],
                    info=info)
