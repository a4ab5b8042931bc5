"""Single-source shortest paths.

JAX rebuild of the reference SSSP primitive
(``gunrock/app/sssp/{sssp_problem,sssp_enactor,sssp_functor}.cuh``):
per-round advance relaxes ``dist[dst] = min(dist[dst], dist[src] + w)``
(functor ``sssp_functor.cuh:59-99``, atomicMin -> deterministic
scatter-min here), the filter dedups improved vertices into the next
frontier. Two scheduling modes:

  * ``mode='bellman'`` — plain advance+filter rounds: exactly what the
    reference snapshot ships (its near-far priority queue call is
    commented out, ``sssp_enactor.cuh:276-330``).
  * ``mode='nearfar'`` — the two-level near-far pile delta-stepping of
    ``gunrock/priority_queue/near_far_pile.cuh``: only vertices with
    ``dist < level * delta`` are relaxed each round; the "far pile" is a
    vertex activity mask re-split when the near bucket drains (the
    ``Bisect`` kernel becomes a masked compaction).

``delta_factor`` matches the C API knob (``gunrock/gunrock.h:98``):
``delta = delta_factor * average_edge_weight``.
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial
from typing import Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..enactor import (LoopStats, capacity_ladder, dispatch_by_size,
                       i32_clip as _i32, init_stats, record_iteration,
                       reset_chunk, Timer)
from ..graph.csr import CsrGraph
from ..graph.device import DeviceGraph, to_device
from ..ops.advance import expand
from ..ops.segment import (compact, frontier_from_mask,
                           mask_from_frontier, scatter_set)
from ..utils.info import make_info

__all__ = ["sssp", "SsspResult", "sssp_device"]

INF = np.float32(np.inf)


@dataclasses.dataclass
class SsspResult:
    distances: np.ndarray          # (V,) float32, +inf unreachable
    preds: Optional[np.ndarray]    # (V,) int32 shortest-path tree parent
    info: dict


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["dist", "frontier", "n", "m_f", "active", "level",
                 "stats"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class _State:
    dist: jax.Array       # (v_pad,) float32
    frontier: jax.Array   # (fcap,) int32 — sorted queue, active first n
    n: jax.Array          # () int32
    m_f: jax.Array        # () int32 — frontier degree sum (next dispatch)
    active: jax.Array     # (v_pad,) bool — improved but not yet relaxed
    level: jax.Array      # () float32 — near/far split threshold
    stats: LoopStats


def _laddered_mf(graph: DeviceGraph, frontier: jax.Array, n: jax.Array,
                 fcap: int):
    """Degree sum of the first ``n`` queue lanes, gathering only the
    smallest ladder rung >= n (a full-fcap gather would put an
    fcap-scale sorted gather in every round)."""
    from ..enactor import frontier_ladder
    ncaps = frontier_ladder(fcap)

    def mk(ncap):
        def f(_):
            fr = jax.lax.dynamic_slice(frontier, (0,), (ncap,)) \
                if ncap < fcap else frontier
            lane = jnp.arange(ncap, dtype=jnp.int32)
            v = jnp.where(lane < n, fr, graph.v_pad - 1)
            s = jnp.take(graph.row_offsets, v, indices_are_sorted=True)
            e = jnp.take(graph.row_offsets, v + 1, indices_are_sorted=True)
            return jnp.sum(jnp.where(lane < n, e - s, 0))
        return f

    if len(ncaps) == 1:
        return mk(fcap)(None)
    return dispatch_by_size(jnp.maximum(n, 1), ncaps, mk, None)


def _relax_payload(graph: DeviceGraph, dist, ex):
    """Gather the expand payloads (dst vertex, weight, source distance)
    as sorted takes."""
    dst = jnp.take(graph.col_indices, ex.eid, indices_are_sorted=True)
    w = jnp.take(graph.edge_values, ex.eid, indices_are_sorted=True)
    dsrc = jnp.take(dist, ex.src, indices_are_sorted=True)
    return dst, w, dsrc


def _winner_minimize(dist, dst, cand, mask, v_pad: int):
    """Deterministic scatter-min: sort lanes by (dst, cand) — the head
    of each dst run carries its min; winners strictly improve ``dist``.
    Replaces the reference's atomicMin race (sssp_functor.cuh:59-99);
    the exact produced sums are what make ``_fill_preds``' float-equality
    parent recovery valid, so every relax path (general rungs and the
    deep micro-loop) MUST route through this one helper. Returns
    ``(dist', sorted_dst, win_mask, sorted_cand)``; winners are sorted
    by construction and ``sorted_cand[win]`` is their new distance."""
    cand = jnp.where(mask, cand, INF)
    dstm = jnp.where(mask, dst, v_pad - 1)
    sd, sc = jax.lax.sort((dstm, cand), num_keys=2)
    head = jnp.concatenate([jnp.ones((1,), jnp.bool_),
                            sd[1:] != sd[:-1]])
    d_old = jnp.take(dist, sd, indices_are_sorted=True)
    win = head & (sc < d_old)
    return scatter_set(dist, sd, sc, mask=win), sd, win, sc


def _bisect(dist, delta, level, near, active):
    """Near-far threshold advance (priority_queue Bisect,
    ``near_far_pile.cuh:35-60``): while the near bucket is empty and the
    pile is not, raise the threshold by ``delta`` and re-split. Identity
    when ``near`` already has work. Shared by the general near-far
    branch and the deep micro-loop's refill."""
    def body(a):
        lvl, _, act = a
        lvl = lvl + delta
        nr = act & (dist < lvl)
        return lvl, nr, act & ~nr

    def cond(a):
        _, nr, act = a
        return (~jnp.any(nr)) & jnp.any(act)

    return jax.lax.while_loop(cond, body, (level, near, active))


def _relax(graph: DeviceGraph, state: _State, cap: int, fcap: int):
    """One push relaxation round over the frontier queue — every
    operation is LANE-scale (proportional to the frontier's edge count),
    no vertex-scale passes:

      1. expand -> eid/rank/src via marker scatters + cumsums (advance.py)
      2. payload: col/w gathered at sorted eid; dist at sorted src
      3. winner resolution: sort lanes by (dst, cand) — the run head
         holds each destination's min — replacing the reference's
         atomicMin race (sssp_functor.cuh:59-99) with a deterministic
         sort + head-select.
      4. scatter the improving winners; they are the (already sorted)
         next frontier.
    """
    in_cap = min(cap, fcap)
    frontier = jax.lax.dynamic_slice(state.frontier, (0,), (in_cap,)) \
        if in_cap < fcap else state.frontier
    ovf = state.n > in_cap
    n0 = jnp.minimum(state.n, in_cap)
    ex = expand(graph, frontier, n0, cap, sorted_frontier=True,
                with_dst=False)
    dst, w, dsrc = _relax_payload(graph, state.dist, ex)
    dist, sd, win, _ = _winner_minimize(state.dist, dst, dsrc + w,
                                        ex.mask, graph.v_pad)
    # Winners are sorted by construction -> next queue needs no re-sort.
    nf, n_next = compact(sd, win, fcap, fill=graph.v_pad - 1)
    m_next = _i32(_laddered_mf(graph, nf, n_next, fcap))
    overflow = (ex.total > cap) | ovf | (n_next > fcap)
    return (dist, nf, _i32(n_next), m_next, ex.total, overflow)


# Micro-loop rung (see models/bfs.py DEEP_CAP): a single rung — a branch
# ladder inside the micro loop forces XLA to copy the V-scale carried
# state per round. Deep entry needs fcap >= 2*DEEP_CAP (the merged queue
# write-back is 2C wide).
DEEP_CAP = 8192


def _make_deep_loop(graph: DeviceGraph, fcap: int, delta, mode: str,
                    upto: jax.Array, upto_edges: jax.Array,
                    carry: bool = False,
                    C: int = DEEP_CAP):
    """Deep-graph regime: many tiny relaxation rounds (road/grid
    diameters). Mirrors the BFS micro-loop (``models/bfs.py``) but keeps
    true near-far scheduling: the rung-scale QUEUE carries every vertex
    with a pending improvement (near and far mixed); each round relaxes
    only the sub-threshold (near) subset, merges the winners back by a
    2C sort-dedup, and advances the threshold one shot when the near
    bucket drains (``near_far_pile.cuh:35-60`` Bisect, algebraically).
    Every operation is DEEP_CAP-scale — none of the vertex-scale
    pile/mask passes of the general near-far step run per round. The
    queue spills to the general ladder (via micro_cond) when it outgrows
    the rung; the far-pile MASK (populated only by general rounds) is
    refilled from at stretch granularity, not per round.

    ``carry=True`` enables queue value-carry: (dist, degree) ride
    alongside each queued vertex in 2C-wide loop-carried arrays, gathered
    from the big arrays once per stretch. The carried dist is exact —
    every improvement re-enqueues its vertex through the merge, whose
    (id, dist) 2-key sort-dedup keeps the minimum entry — so the
    per-round dist gather, the per-edge source-dist gather, and the
    2C-wide degree re-gather all collapse to rung-scale takes; the one
    remaining big gather per round is the winners' degrees."""
    lane = jnp.arange(C, dtype=jnp.int32)
    lane2 = jnp.arange(2 * C, dtype=jnp.int32)
    SENT = jnp.int32(0x7FFFFFF0)
    # Loop-invariant (XLA's while-LICM hoists it out of the micro loop):
    # one degree gather per round instead of two row_offsets gathers.
    deg_arr = graph.row_offsets[1:] - graph.row_offsets[:-1]
    nearfar = mode == "nearfar"

    def micro_cond(st: _State):
        return (st.n > 0) & (st.n <= C) & (st.m_f <= C) & \
               (st.stats.iteration < upto) & \
               (st.stats.chunk_edges < upto_edges) & \
               (~st.stats.overflow)

    def micro_body(st: _State):
        q = jax.lax.dynamic_slice(st.frontier, (0,), (C,))
        valid = lane < st.n
        q = jnp.where(valid, q, graph.v_pad - 1)
        dq = jnp.take(st.dist, q, indices_are_sorted=True)
        near, level = _split_near(st, dq, valid)

        # Relax the near subset (C-scale; a no-op round when empty).
        nq, nn = compact(q, near, C, fill=graph.v_pad - 1)
        ex = expand(graph, nq, _i32(nn), C, sorted_frontier=True,
                    with_dst=False)
        dst, w, dsrc = _relax_payload(graph, st.dist, ex)
        dist, sd, win, _ = _winner_minimize(st.dist, dst, dsrc + w,
                                            ex.mask, graph.v_pad)

        # New queue = (queued \ relaxed-near) | winners: 2C sort-dedup.
        merged = jax.lax.sort(jnp.concatenate(
            [jnp.where(valid & ~near, q, SENT),
             jnp.where(win, sd, SENT)]))
        mhead = jnp.concatenate([jnp.ones((1,), jnp.bool_),
                                 merged[1:] != merged[:-1]])
        keep = mhead & (merged < SENT)
        newq, n2 = compact(merged, keep, 2 * C, fill=graph.v_pad - 1)
        n2 = _i32(n2)
        deg = jnp.take(deg_arr, newq, indices_are_sorted=True)
        m2 = _i32(jnp.sum(jnp.where(lane2 < n2, deg, 0)))
        frontier = jax.lax.dynamic_update_slice(st.frontier, newq, (0,))
        stats = record_iteration(st.stats, frontier_len=n2,
                                 edges=ex.total)
        return _State(dist=dist, frontier=frontier, n=n2, m_f=m2,
                      active=st.active, level=level, stats=stats)

    def _split_near(st, dq, valid):
        """Near/far split + one-shot Bisect on the rung-scale dist
        vector (shared by BOTH micro bodies — the modes must stay
        bitwise-identical). When the near bucket is empty the threshold
        jumps just past the cheapest queued tentative distance; the
        float32 guard makes the jump clear ``min_dq`` STRICTLY (near
        uses ``dq < level``) or the micro loop would spin on an empty
        near bucket until the chunk budget drains."""
        if not nearfar:
            return valid, st.level
        near = valid & (dq < st.level)
        any_near = jnp.any(near)
        min_dq = jnp.min(jnp.where(valid, dq, INF))
        k = jnp.maximum(
            jnp.floor((min_dq - st.level) / delta) + 1.0, 1.0)
        jumped = st.level + k * delta
        jumped = jnp.where(jumped > min_dq, jumped,
                           jnp.nextafter(min_dq, INF))
        level = jnp.where(any_near, st.level, jumped)
        return near, level

    def micro_body_carry(c):
        st, qd, qg = c
        q = jax.lax.dynamic_slice(st.frontier, (0,), (C,))
        valid = lane < st.n
        q = jnp.where(valid, q, graph.v_pad - 1)
        dq = qd[:C]                       # carried — no dist gather
        near, level = _split_near(st, dq, valid)

        # Near subset positions (order-preserving -> nq stays sorted);
        # payload dist comes from the carried rung array.
        nidx, nn = compact(lane, near, C, fill=0)
        nn = _i32(nn)
        nq = jnp.where(lane < nn, jnp.take(q, nidx), graph.v_pad - 1)
        ndq = jnp.take(dq, nidx)
        ex = expand(graph, nq, nn, C, sorted_frontier=True,
                    with_dst=False)
        dst = jnp.take(graph.col_indices, ex.eid, indices_are_sorted=True)
        w = jnp.take(graph.edge_values, ex.eid, indices_are_sorted=True)
        # ex.rank is nondecreasing across ALL lanes (cumsum-built), so
        # the sorted-gather hint holds; clip handles the invalid tail
        # (those lanes are masked out in _winner_minimize anyway).
        dsrc = jnp.take(ndq, ex.rank, indices_are_sorted=True,
                        mode="clip")
        dist, sd, win, sc = _winner_minimize(st.dist, dst, dsrc + w,
                                             ex.mask, graph.v_pad)
        # The ONE remaining big-array gather: winners' degrees.
        wdeg = jnp.take(deg_arr, sd, indices_are_sorted=True) \
            .astype(jnp.int32)

        # Merge with payloads: 2-key (id, dist) sort keeps the min-dist
        # entry at each id run head; degrees ride along.
        far = valid & ~near
        ids = jnp.concatenate([jnp.where(far, q, SENT),
                               jnp.where(win, sd, SENT)])
        ds = jnp.concatenate([jnp.where(far, dq, INF),
                              jnp.where(win, sc, INF)])
        gs = jnp.concatenate([jnp.where(far, qg[:C], 0),
                              jnp.where(win, wdeg, 0)])
        sids, sds, sgs = jax.lax.sort((ids, ds, gs), num_keys=2)
        mhead = jnp.concatenate([jnp.ones((1,), jnp.bool_),
                                 sids[1:] != sids[:-1]])
        keep = mhead & (sids < SENT)
        kidx, n2 = compact(lane2, keep, 2 * C, fill=0)
        n2 = _i32(n2)
        kvalid = lane2 < n2
        newq = jnp.where(kvalid, jnp.take(sids, kidx), graph.v_pad - 1)
        newd = jnp.take(sds, kidx)
        newg = jnp.where(kvalid, jnp.take(sgs, kidx), 0)
        m2 = _i32(jnp.sum(newg))          # carried — no degree re-gather
        frontier = jax.lax.dynamic_update_slice(st.frontier, newq, (0,))
        stats = record_iteration(st.stats, frontier_len=n2,
                                 edges=ex.total)
        st2 = _State(dist=dist, frontier=frontier, n=n2, m_f=m2,
                     active=st.active, level=level, stats=stats)
        return st2, newd, newg

    def micro(state: _State):
        if not carry:
            return jax.lax.while_loop(micro_cond, micro_body, state)
        # Stretch entry: one 2C gather each for dist + degree.
        q2 = jax.lax.dynamic_slice(state.frontier, (0,), (2 * C,))
        q2 = jnp.where(lane2 < state.n, q2, graph.v_pad - 1)
        qd = jnp.take(state.dist, q2, indices_are_sorted=True)
        qg = jnp.take(deg_arr, q2, indices_are_sorted=True) \
            .astype(jnp.int32)
        out = jax.lax.while_loop(lambda c: micro_cond(c[0]),
                                 micro_body_carry, (state, qd, qg))
        return out[0]

    if mode != "nearfar":
        return micro

    lane_f = jnp.arange(fcap, dtype=jnp.int32)

    def run(state: _State):
        st = micro(state)

        def refill(st: _State):
            dist = st.dist
            level, near, active = _bisect(
                dist, delta, st.level, jnp.zeros_like(st.active),
                st.active)
            nq, n = frontier_from_mask(near, fcap)
            nq = jnp.where(lane_f < n, nq, graph.v_pad - 1)
            deg = graph.row_offsets[1:] - graph.row_offsets[:-1]
            m_f = _i32(jnp.sum(jnp.where(near, deg, 0)))
            stats = dataclasses.replace(
                st.stats, overflow=st.stats.overflow | (n > fcap))
            return _State(dist=dist, frontier=nq, n=_i32(n), m_f=m_f,
                          active=active, level=level, stats=stats)

        return jax.lax.cond((st.n == 0) & jnp.any(st.active), refill,
                            lambda s: s, st)

    return run


def _make_bellman_branch(graph, fcap):
    def make(cap):
        def step(state: _State):
            dist, nf, n, m_f, edges, overflow = _relax(graph, state, cap,
                                                       fcap)
            return dist, nf, n, m_f, state.active, state.level, \
                edges, overflow
        return step
    return make


def _make_nearfar_branch(graph, fcap, delta):
    deg = graph.row_offsets[1:] - graph.row_offsets[:-1]

    def make(cap):
        def step(state: _State):
            dist, nf, n_imp, _, edges, overflow = _relax(graph, state, cap,
                                                         fcap)
            # Improved vertices enter the pile; the near bucket (below
            # the current threshold) becomes the next frontier
            # (priority_queue Bisect, near_far_pile.cuh:35-60).
            imp_mask = mask_from_frontier(nf, n_imp, graph.v_pad)
            active = state.active | imp_mask
            near = active & (dist < state.level)
            active = active & ~near

            # Bucket empty -> advance the threshold until work appears
            # or the pile drains (dense vertex-scale ops only).
            level, near, active = _bisect(dist, delta, state.level, near,
                                          active)
            nq, n = frontier_from_mask(near, fcap)
            nq = jnp.where(jnp.arange(fcap, dtype=jnp.int32) < n, nq,
                           graph.v_pad - 1)
            m_f = _i32(jnp.sum(jnp.where(near, deg, 0)))
            return dist, nq, _i32(n), m_f, active, level, edges, \
                overflow | (n > fcap)
        return step
    return make


def _sssp_loop(graph: DeviceGraph, state, upto: jax.Array,
               delta: jax.Array, upto_edges: jax.Array, *,
               fcap: int, caps: tuple[int, ...], mode: str,
               init: bool = False, deep_carry: bool = False):
    """Run relaxation rounds until convergence, ``upto`` iterations, or
    ``upto_edges`` relaxed edge-lanes THIS CHUNK (the host resets the
    exact int32 ``stats.chunk_edges`` counter before every chunk call, so
    the budget compare never degrades from float accumulation).

    Both bounds exist so the host can enact in chunks (one compiled
    while_loop per chunk), as the reference's enactor drives rounds
    from the host. The edge bound is the one that tracks device
    time (a round costs ~its edge count); the iteration bound caps
    per-round loop overhead on deep graphs."""
    if init:
        state = _sssp_init(graph, state, mode, delta, fcap)
    if mode == "nearfar":
        branch = _make_nearfar_branch(graph, fcap, delta)
    else:
        branch = _make_bellman_branch(graph, fcap)
    # Micro-rung ladder (see models/bfs._deep_rungs): one micro-loop per
    # rung width, dispatched at stretch granularity.
    from .bfs import _deep_rungs
    deeps = []
    if os.environ.get("GUNROCK_SSSP_DEEP", "1") == "1":
        deeps = [(c, _make_deep_loop(graph, fcap, delta, mode, upto,
                                     upto_edges, carry=deep_carry, C=c))
                 for c in _deep_rungs("GUNROCK_SSSP_DEEP_RUNGS", DEEP_CAP)
                 if fcap >= 2 * c]
    deep = deeps[-1][1] if deeps else None
    deep_cap_max = deeps[-1][0] if deeps else DEEP_CAP

    def cond(state: _State):
        return (state.n > 0) & (state.stats.iteration < upto) & \
               (state.stats.chunk_edges < upto_edges) & \
               (~state.stats.overflow)

    def general(state: _State):
        out = dispatch_by_size(jnp.maximum(state.m_f, state.n), caps,
                               branch, state)
        dist, frontier, n, m_f, active, level, edges, overflow = out
        stats = record_iteration(state.stats, frontier_len=n, edges=edges,
                                 overflow=overflow)
        return _State(dist=dist, frontier=frontier, n=n, m_f=m_f,
                      active=active, level=level, stats=stats)

    def deep_dispatch(state: _State):
        ds = jnp.maximum(state.m_f, state.n)

        def level(i):
            if i == len(deeps) - 1:
                return deeps[i][1]
            return lambda s: jax.lax.cond(ds <= deeps[i][0], deeps[i][1],
                                          level(i + 1), s)

        return level(0)(state)

    def body(state: _State):
        if deep is None:
            return general(state)
        return jax.lax.cond(
            jnp.maximum(state.m_f, state.n) <= deep_cap_max,
            deep_dispatch, general, state)

    out = jax.lax.while_loop(cond, body, state)
    # m_f rides in the packed probe so instrumented mode attributes each
    # round to its phase (push ladder / deep micro-loop)
    # without an extra device fetch.
    probe = jnp.stack([out.stats.iteration,
                       out.stats.overflow.astype(jnp.int32), out.n,
                       out.m_f])
    return out, probe


def _sssp_init(graph: DeviceGraph, src: jax.Array, mode: str,
               delta: float, fcap: int) -> _State:
    v_pad = graph.v_pad
    return _State(
        dist=jnp.full((v_pad,), INF, jnp.float32).at[src].set(0.0),
        frontier=jnp.full((fcap,), v_pad - 1, jnp.int32).at[0].set(src),
        n=jnp.int32(1),
        m_f=jnp.minimum(graph.row_offsets[src + 1] -
                        graph.row_offsets[src],
                        2**31 - 1).astype(jnp.int32),
        active=jnp.zeros((v_pad,), jnp.bool_),
        level=jnp.float32(delta if mode == "nearfar" else 0.0),
        stats=init_stats(),
    )


def _fill_preds(graph: DeviceGraph, dist: jax.Array) -> jax.Array:
    """Post-hoc shortest-path-tree parents: pred(v) = last in-neighbor u
    (CSC order) with dist[u] + w(u,v) == dist[v]. Exact float equality
    holds because dist[v] was produced as exactly that sum by the
    deterministic scatter-min. One pass, outside the loop."""
    v_pad = graph.v_pad
    dst_of_edge = graph.csc_edge_dst.clip(0, v_pad - 1)
    hit = (dist[graph.csc_indices] + graph.csc_edge_values ==
           dist[dst_of_edge])
    pos = jnp.where(hit, jnp.arange(graph.e_pad, dtype=jnp.int32), -1)
    best = jax.lax.cummax(pos)
    bpos0 = jnp.concatenate([jnp.full((1,), -1, jnp.int32), best])
    last = jnp.take(bpos0, graph.csc_offsets[1:], indices_are_sorted=True)
    start = graph.csc_offsets[:-1]
    ok = jnp.isfinite(dist[:v_pad]) & (dist[:v_pad] > 0) & (last >= start)
    return jnp.where(ok, graph.csc_indices[jnp.maximum(last, 0)], -1)


_sssp_jit = jax.jit(
    _sssp_loop,
    # delta stays dynamic (a traced f32): sweeping it must not recompile.
    static_argnames=("fcap", "caps", "mode", "init", "deep_carry"),
)


def sssp_device(graph: DeviceGraph, src, *, mark_preds: bool = False,
                mode: str = "bellman", delta: float = 1.0,
                queue_sizing: float = 1.0,
                max_iters: Optional[int] = None,
                chunk_iters: Optional[int] = None,
                instrument: Optional[list] = None,
                deep_carry: Optional[bool] = None):
    """``instrument``: pass a list to enact one round per device call and
    collect per-round wall-clock records (reference ``--instrumented``
    kernel stats, ``util/kernel_runtime_stats.cuh``); adds per-call
    dispatch overhead, exactly like the reference's instrumented runs.
    ``deep_carry`` enables queue value-carry in the deep micro-loop
    (defaults to the GUNROCK_SSSP_CARRY env var; see _make_deep_loop)."""
    if deep_carry is None:
        deep_carry = os.environ.get("GUNROCK_SSSP_CARRY", "0") == "1"
    if not graph.has_edge_values:
        raise ValueError("SSSP needs to_device(with_edge_values=True)")
    fcap = max(128, int(graph.v_pad * min(queue_sizing, 1.0)))
    out_cap = max(128, int(graph.e_pad * min(queue_sizing, 1.0)))
    caps = tuple(capacity_ladder(out_cap, step=4))
    if max_iters is None:
        max_iters = 4 * graph.num_nodes + 16
    if chunk_iters is None:
        # Many micro rounds per chunk are fine (each is DEEP_CAP-scale);
        # the edge budget below is what bounds big rounds.
        chunk_iters = 16384
    # Per-chunk edge-lane budget: bounds device time per call (a round
    # costs ~its edge count).
    chunk_edges = int(min(4 * max(graph.e_pad, 1), 1 << 29))
    if instrument is not None:
        chunk_iters = 1
    def chunk(st, upto, first):
        return _sssp_jit(graph, st, jnp.int32(upto), jnp.float32(delta),
                         jnp.int32(chunk_edges),
                         fcap=fcap, caps=caps, mode=mode, init=first,
                         deep_carry=deep_carry)

    # Chunked enactment (see bfs_device).
    import time as _time
    t0 = _time.perf_counter()
    deep_on = fcap >= 2 * DEEP_CAP
    if instrument is not None:
        prev_dispatch = max(int(np.asarray(
            graph.row_offsets[int(src) + 1]
            - graph.row_offsets[int(src)])), 1)
    upto = min(chunk_iters, max_iters)
    state, probe = chunk(jnp.int32(src), upto, True)
    while True:
        it, ovf, n, m_f = (int(x) for x in np.asarray(probe))
        if instrument is not None:
            t1 = _time.perf_counter()
            # Phase = the branch body() dispatched on the PRE-round
            # dispatch size (reference per-stage subqueue/fullqueue
            # timers, enactor_types.cuh:67-72).
            phase = ("deep" if deep_on and prev_dispatch <= DEEP_CAP
                     else "push")
            instrument.append({
                "iteration": it, "ms": (t1 - t0) * 1e3, "frontier": n,
                "m_f": m_f, "phase": phase})
            t0 = t1
            prev_dispatch = max(m_f, n)
        if ovf or n == 0 or it >= max_iters:
            break
        upto = min(it + chunk_iters, max_iters)
        state = dataclasses.replace(state,
                                    stats=reset_chunk(state.stats))
        state, probe = chunk(state, upto, False)
    preds = jnp.zeros((1,), jnp.int32)
    if mark_preds:
        preds = jax.jit(_fill_preds)(graph, state.dist)
    return state.dist, preds, state.stats


def sssp(graph: Union[CsrGraph, DeviceGraph], src: Union[int, str] = 0, *,
         mark_preds: bool = False, mode: str = "bellman",
         delta_factor: float = 32.0, queue_sizing: float = 1.0,
         max_iters: Optional[int] = None,
         instrumented: bool = False) -> SsspResult:
    """Run SSSP from ``src`` (C API parity: ``gunrock_sssp``,
    ``gunrock.h:253``; ``mark_preds`` = MARK_PATHS; ``instrumented``
    collects per-round records into ``info["per_iteration"]``)."""
    timer = Timer()
    per_iter: Optional[list] = [] if instrumented else None
    num_nodes = graph.num_nodes
    delta = 1.0
    if isinstance(graph, CsrGraph):
        if src == "largestdegree":
            src = graph.largest_degree_vertex()
        if graph.edge_values is None:
            graph.random_edge_values()
        if graph.num_edges:
            delta = delta_factor * float(np.mean(graph.edge_values))
        with timer.time("preprocess_ms"):
            dgraph = to_device(graph, with_edge_values=True,
                               with_csc=mark_preds)
    else:
        dgraph = graph
        if mode == "nearfar" and graph.num_edges and graph.has_edge_values:
            delta = delta_factor * float(
                jnp.mean(graph.edge_values[:graph.num_edges]))
    src = int(src)
    if not 0 <= src < num_nodes:
        raise ValueError(f"src {src} out of range [0, {num_nodes})")

    with timer.time("process_ms"):
        dist, preds, stats = jax.block_until_ready(
            sssp_device(dgraph, src, mark_preds=mark_preds, mode=mode,
                        delta=delta, queue_sizing=queue_sizing,
                        max_iters=max_iters, instrument=per_iter))

    dist_np = np.asarray(dist)[:num_nodes]
    preds_np = np.asarray(preds)[:num_nodes] if mark_preds else None
    reached = np.isfinite(dist_np)
    degs = np.diff(np.asarray(dgraph.row_offsets)[:num_nodes + 1]).astype(np.int64)
    info = make_info(
        primitive="sssp", graph=dgraph, stats=stats, timer=timer,
        edges_visited=int(degs[reached].sum()),
        extra={"src": src, "mark_paths": mark_preds, "mode": mode,
               "instrumented": instrumented,
               "search_depth": int(stats.iteration),
               **({"per_iteration": per_iter} if instrumented else {})},
    )
    return SsspResult(distances=dist_np, preds=preds_np, info=info)
