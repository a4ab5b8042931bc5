"""Breadth-first search (+ direction-optimized BFS).

JAX rebuild of the reference BFS primitive
(``gunrock/app/bfs/{bfs_problem,bfs_enactor,bfs_functor}.cuh``):

  * label-setting BFS — every newly reached vertex gets label = depth
    (functor ``bfs_functor.cuh:57-118``); the reference's atomicMin /
    idempotent-bitmask race is replaced by a deterministic claim-scatter,
    so labels AND predecessors are bitwise reproducible.
  * optional predecessor marking (``MARK_PREDECESSORS``, 1 vertex-associate).
  * direction-optimized push/pull switching (``bfs_enactor.cuh:852-939``):
    push = frontier neighbor expansion over CSR, pull = full-edge masked
    reduction over CSC; per-iteration decision from frontier/unexplored
    edge counts (Beamer-style alpha/beta, reference knobs do_a/do_b,
    ``bfs_enactor.cuh:1829-1830``).
  * the whole traversal compiles to one ``lax.while_loop`` — no host
    round-trips; advance output capacity is picked per iteration from a
    geometric ladder (reference LB vs LB_LIGHT dispatch).

The dedup "idempotence" question disappears here: the claim filter is
exact, so each vertex enters the frontier exactly once regardless of the
reference's ENABLE_IDEMPOTENCE template flag (kept in the API for parity;
it has no effect on results here, only matching the reference's always-
correct configurations).
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
                       Timer)
from ..graph.csr import CsrGraph
from ..graph.device import DeviceGraph, to_device
from ..ops.advance import expand
from ..ops.segment import (compact, dedup_winners, frontier_from_mask,
                           scatter_set)
from ..utils.info import make_info

__all__ = ["bfs", "BfsResult", "bfs_device"]

INVALID = np.int32(-1)


@dataclasses.dataclass
class BfsResult:
    labels: np.ndarray            # (V,) int32 depth, -1 unreachable
    preds: Optional[np.ndarray]   # (V,) int32 predecessor, -1 for src/unreached
    info: dict                    # reference Info JSON-style run record


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["labels", "preds", "frontier", "n", "m_f", "fvalid",
                 "use_pull", "unexplored", "stats"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class _State:
    labels: jax.Array      # (v_pad,) int32
    preds: jax.Array       # (v_pad,) or (1,) int32
    frontier: jax.Array    # (fcap,) int32
    n: jax.Array           # () int32
    m_f: jax.Array         # () int32 — degree sum of the current frontier,
    #                          maintained by the producing step so the hot
    #                          loop never rescans the frontier
    fvalid: jax.Array      # () bool — frontier queue in sync with labels
    #                          (pull mode skips materializing the queue;
    #                           push rebuilds it lazily on mode switch)
    use_pull: jax.Array    # () bool
    unexplored: jax.Array  # () float32 — approx edges out of unvisited vertices
    stats: LoopStats



def _frontier_degree_sum(graph: DeviceGraph, frontier: jax.Array,
                         n: jax.Array) -> jax.Array:
    lane = jnp.arange(frontier.shape[0], dtype=jnp.int32)
    valid = lane < n
    f = jnp.where(valid, frontier, 0)
    deg = jnp.where(valid, graph.row_offsets[f + 1] - graph.row_offsets[f], 0)
    return jnp.sum(deg)


def _single_source_step(graph: DeviceGraph, cap: int, mark_preds: bool,
                        state: _State, frontier0: jax.Array,
                        depth: jax.Array):
    """Fast path for a 1-vertex frontier (every traversal's first
    iteration; the reference's first advance is equally degenerate but
    pays full kernel-launch machinery). The vertex's CSR run is one
    contiguous dynamic_slice — no rank assignment, no dedup claims, no
    compaction. The frontier queue is left unmaterialized
    (``fvalid=False``); a following push iteration lazily rebuilds it
    from the label mask, a following pull ignores it anyway."""
    v = frontier0[0]
    e_pad = graph.e_pad
    start = graph.row_offsets[v]
    deg = graph.row_offsets[v + 1] - start
    off = jnp.minimum(start, e_pad - cap)
    nbr = jax.lax.dynamic_slice(graph.col_indices, (off,), (cap,))
    j = jnp.arange(cap, dtype=jnp.int32)
    lo = start - off
    # Multi-edges may duplicate lanes; duplicate label/pred writes carry
    # identical values and n/m_f merely overcount them (stats only).
    in_run = (j >= lo) & (j < lo + deg)
    is_new = in_run & (state.labels[jnp.where(in_run, nbr, 0)] == INVALID)
    labels = scatter_set(state.labels, nbr, depth, mask=is_new)
    preds = state.preds
    if mark_preds:
        preds = scatter_set(preds, nbr, v, mask=is_new)
    n, m_f_next = _dense_next_stats(graph, labels, depth, cap, is_new, nbr)
    return (labels, preds, state.frontier, n, m_f_next,
            jnp.bool_(False), _i32(deg), deg > cap)


def _dense_next_stats(graph: DeviceGraph, labels: jax.Array,
                      depth: jax.Array, cap: int, is_new: jax.Array,
                      dst: jax.Array):
    """Next-frontier count and degree sum. Big rungs count DENSELY from
    the updated labels (sequential v-scale reads, also dedup-exact);
    small rungs stay on the lane-scale path (two random gathers beat a
    v_pad-scale pass there)."""
    if cap >= graph.v_pad // 8:
        new_mask = labels == depth
        deg = graph.row_offsets[1:] - graph.row_offsets[:-1]
        return (_i32(jnp.sum(new_mask.astype(jnp.int32))),
                _i32(jnp.sum(jnp.where(new_mask, deg, 0))))
    deg_dst = graph.row_offsets[dst + 1] - graph.row_offsets[dst]
    return (_i32(jnp.sum(is_new.astype(jnp.int32))),
            _i32(jnp.sum(jnp.where(is_new, deg_dst, 0))))


def _make_push_branch(graph: DeviceGraph, fcap: int, mark_preds: bool,
                      may_rebuild: bool = True):
    def make(cap: int):
        def general(state: _State, frontier0, n0, depth):
            rebuild_ovf = n0 > fcap      # queue too small for this frontier
            n0 = jnp.minimum(n0, fcap)
            # Input-side laddering: the expansion must not scan the
            # full queue capacity for small frontiers — slice to the
            # rung width (the dispatch size is max(m_f, n), so the rung
            # bounds the frontier length too).
            in_cap = min(cap, fcap)
            frontier0 = jax.lax.dynamic_slice(frontier0, (0,), (in_cap,))
            rebuild_ovf = rebuild_ovf | (n0 > in_cap)
            n0 = jnp.minimum(n0, in_cap)
            # Sort the (sliced) frontier so every gather in the
            # expansion is monotonic — the sort itself is rung-width,
            # so it is cheap on every rung.
            fr = jnp.sort(jnp.where(
                jnp.arange(in_cap, dtype=jnp.int32) < n0, frontier0,
                jnp.int32(0x7FFFFFF0)))
            fr = jnp.minimum(fr, graph.v_pad - 1)
            ex = expand(graph, fr, n0, cap, sorted_frontier=True)
            is_new = ex.mask & (state.labels[ex.dst] == INVALID)
            if may_rebuild and cap >= graph.v_pad // 4:
                # DO mode, big rung: duplicate dst lanes write identical
                # labels (and a deterministic last-wins pred), so the
                # claim-dedup and queue compaction — two cap-scale
                # scatter+gather pairs — are pure overhead. Leave the
                # queue unmaterialized; stats count densely (dedup-exact)
                # and a following push rebuilds the queue lazily.
                labels = scatter_set(state.labels, ex.dst, depth,
                                     mask=is_new)
                preds = state.preds
                if mark_preds:
                    preds = scatter_set(preds, ex.dst, ex.src, mask=is_new)
                n, m_f_next = _dense_next_stats(graph, labels, depth, cap,
                                                is_new, ex.dst)
                overflow = (ex.total > cap) | rebuild_ovf
                return (labels, preds, state.frontier, n, m_f_next,
                        jnp.bool_(False), ex.total, overflow)
            keep = dedup_winners(ex.dst, is_new, graph.v_pad)
            labels = scatter_set(state.labels, ex.dst, depth, mask=keep)
            preds = state.preds
            if mark_preds:
                preds = scatter_set(preds, ex.dst, ex.src, mask=keep)
            frontier, n = compact(ex.dst, keep, fcap)
            deg_dst = graph.row_offsets[ex.dst + 1] - graph.row_offsets[ex.dst]
            m_f_next = _i32(jnp.sum(jnp.where(keep, deg_dst, 0)))
            overflow = (ex.total > cap) | (n > fcap) | rebuild_ovf
            return (labels, preds, frontier, n, m_f_next,
                    jnp.bool_(True), ex.total, overflow)

        def step(state: _State):
            depth = state.stats.iteration + 1
            cur = state.stats.iteration
            if may_rebuild:
                # Lazy queue rebuild after pull iterations (the pull step
                # leaves the frontier as the label mask).
                frontier0, n0 = jax.lax.cond(
                    state.fvalid,
                    lambda: (state.frontier, state.n),
                    lambda: frontier_from_mask(state.labels == cur, fcap),
                )
                # Single-vertex frontiers skip the whole expansion
                # machinery (fvalid=False afterwards, so only usable when
                # a later push may rebuild the queue lazily).
                return jax.lax.cond(
                    n0 == 1,
                    lambda: _single_source_step(graph, cap, mark_preds,
                                                state, frontier0, depth),
                    lambda: general(state, frontier0, n0, depth),
                )
            return general(state, state.frontier, state.n, depth)
        return step
    return make


# Micro-loop rung: every op stays at this scale. A single rung — a
# lax.switch ladder inside the micro loop forces XLA to copy the V-scale
# carried state per level. Sized so a
# road/grid wavefront's edge volume fits (grid wavefronts run ~4*side
# lanes: side 1448 -> m_f ~5790).
DEEP_CAP = 8192


def _deep_rungs(env: str, default: int) -> tuple:
    """Micro-loop rung widths from a comma env list (ascending). Each
    rung gets its own while_loop whose every op runs at that width, so
    a small level on a narrow rung touches fewer lanes. Dispatch between
    rungs happens at STRETCH granularity (outer-body lax.cond) — a rung
    switch per round would copy the V-scale carried state every level."""
    raw = os.environ.get(env, "")
    if not raw:
        return (default,)
    return tuple(sorted({int(x) for x in raw.split(",") if x}))


def _make_deep_loop(graph: DeviceGraph, fcap: int, mark_preds: bool,
                    upto: jax.Array, C: int = DEEP_CAP):
    """Deep-graph regime: many tiny levels (road/grid diameters).

    The general push rung pays per-level costs that dwarf a tiny
    frontier's edges: the ladder switch, the V-scale claim table in
    ``dedup_winners``, and the fcap-wide queue compaction. This inner
    while_loop runs whole stretches of small levels with every operation
    at DEEP_CAP scale: duplicate destinations are culled by a stable
    rung-width sort (first lane of each run wins — deterministic, like
    the claim dedup) and the compacted frontier writes back through a
    DEEP_CAP-wide dynamic_update_slice. Exits when the frontier's edge
    volume outgrows the rung (outer ladder takes over), at convergence,
    or at the ``upto`` chunk bound. Reference context: the small-frontier
    path of the LB advance (RelaxLightEdges,
    ``oprtr/edge_map_partitioned/kernel.cuh:355``)."""
    lane = jnp.arange(C, dtype=jnp.int32)
    # Loop-invariant (XLA's while-LICM hoists it out of the micro loop):
    # one degree gather per round instead of two row_offsets gathers.
    deg_arr = graph.row_offsets[1:] - graph.row_offsets[:-1]

    def micro_cond(st: _State):
        return (st.n > 0) & (st.m_f <= C) & (st.n <= C) & \
               (st.stats.iteration < upto) & (~st.stats.overflow)

    def micro_body(st: _State):
        depth = st.stats.iteration + 1
        # The queue is sorted by invariant: entry frontiers are sorted
        # once in run(), and each round's compact of the sorted key
        # stream (tail pinned high) preserves order.
        fr = jax.lax.dynamic_slice(st.frontier, (0,), (C,))
        ex = expand(graph, fr, st.n, C, sorted_frontier=True,
                    with_src=mark_preds)
        is_new = ex.mask & (st.labels[ex.dst] == INVALID)
        key = jnp.where(is_new, ex.dst, jnp.int32(0x7FFFFFF0))
        if mark_preds:
            key_s, src_s = jax.lax.sort((key, ex.src), num_keys=1,
                                        is_stable=True)
        else:
            key_s = jax.lax.sort(key, is_stable=True)
        keep = (key_s < jnp.int32(0x7FFFFFF0)) & jnp.concatenate(
            [jnp.ones((1,), jnp.bool_), key_s[1:] != key_s[:-1]])
        labels = scatter_set(st.labels, key_s, depth, mask=keep)
        preds = st.preds
        if mark_preds:
            preds = scatter_set(preds, key_s, src_s, mask=keep)
        newf, n_next = compact(key_s, keep, C, fill=graph.v_pad - 1)
        deg = jnp.take(deg_arr, newf, indices_are_sorted=True)
        m_f_next = _i32(jnp.sum(jnp.where(lane < n_next, deg, 0)))
        frontier = jax.lax.dynamic_update_slice(st.frontier, newf, (0,))
        stats = record_iteration(st.stats, frontier_len=n_next,
                                 edges=ex.total)
        return _State(
            labels=labels, preds=preds, frontier=frontier, n=n_next,
            m_f=m_f_next, fvalid=jnp.bool_(True),
            use_pull=jnp.bool_(False),
            unexplored=st.unexplored - st.m_f.astype(jnp.float32),
            stats=stats,
        )

    def run(state: _State):
        # Sort the entry frontier once per stretch (the general rungs
        # hand over unsorted queues); every micro round keeps the queue
        # sorted from there.
        fr = jax.lax.dynamic_slice(state.frontier, (0,), (C,))
        fr = jnp.sort(jnp.where(lane < state.n, fr,
                                jnp.int32(0x7FFFFFF0)))
        fr = jnp.minimum(fr, graph.v_pad - 1)
        frontier = jax.lax.dynamic_update_slice(state.frontier, fr, (0,))
        state = dataclasses.replace(state, frontier=frontier)
        return jax.lax.while_loop(micro_cond, micro_body, state)
    return run


def _pull_step(graph: DeviceGraph, fcap: int, mark_preds: bool,
               state: _State):
    """Full-edge pull over CSC: v joins the frontier iff any in-neighbor is
    in the current frontier (reference TWC/LB backward advance with
    frontier bitmaps, ``oprtr/advance/kernel.cuh:355-379``).

    The segmented OR is the cumsum-boundary trick: reached(v) = any hit
    in v's CSC row = (running_sum[row_end] - running_sum[row_start]) > 0
    — one scan plus one sorted vertex-scale gather instead of an
    edge-scale scatter. Predecessors for pull-discovered vertices are
    filled post-hoc (:func:`_fill_preds`), keeping the hot loop free of
    edge-scale irregular writes."""
    depth = state.stats.iteration + 1
    cur = state.stats.iteration
    hit = (state.labels[graph.csc_indices] == cur).astype(jnp.int32)
    run0 = jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.cumsum(hit)])
    # One sorted gather at all row boundaries, then adjacent diffs.
    samples = jnp.take(run0, graph.csc_offsets, indices_are_sorted=True)
    reached = (samples[1:] - samples[:-1]) > 0
    new_mask = (state.labels == INVALID) & reached
    labels = jnp.where(new_mask, depth, state.labels)
    n = _i32(jnp.sum(new_mask.astype(jnp.int32)))
    deg = graph.row_offsets[1:] - graph.row_offsets[:-1]
    m_f_next = _i32(jnp.sum(jnp.where(new_mask, deg, 0)))
    edges = jnp.int32(min(graph.num_edges, 2**31 - 1))
    # Skip materializing the queue: the frontier IS labels == depth.
    return (labels, state.preds, state.frontier, n, m_f_next,
            jnp.bool_(False), edges, jnp.bool_(False))


def _fill_preds(graph: DeviceGraph, labels: jax.Array,
                preds: jax.Array) -> jax.Array:
    """Post-hoc predecessor fill for vertices discovered in pull mode:
    pred(v) = the last in-neighbor (CSC order) with label(v) - 1.
    Deterministic, one pass, outside the traversal loop."""
    lab_dst = labels[graph.csc_edge_dst.clip(0, graph.v_pad - 1)]
    hit = labels[graph.csc_indices] + 1 == lab_dst
    pos = jnp.where(hit, jnp.arange(graph.e_pad, dtype=jnp.int32), -1)
    best = jax.lax.cummax(pos)
    bpos0 = jnp.concatenate([jnp.full((1,), -1, jnp.int32), best])
    last = bpos0[graph.csc_offsets[1:]]
    start = graph.csc_offsets[:-1]
    ok = (labels[: graph.v_pad] > 0) & (preds == INVALID) & (last >= start)
    return jnp.where(ok, graph.csc_indices[jnp.maximum(last, 0)], preds)


def _bfs_init(graph: DeviceGraph, src: jax.Array, fcap: int,
              mark_preds: bool) -> _State:
    v_pad = graph.v_pad
    labels = jnp.full((v_pad,), INVALID, jnp.int32).at[src].set(0)
    preds = (jnp.full((v_pad,), INVALID, jnp.int32) if mark_preds
             else jnp.zeros((1,), jnp.int32))
    return _State(
        labels=labels, preds=preds,
        frontier=jnp.zeros((fcap,), jnp.int32).at[0].set(src),
        n=jnp.int32(1),
        m_f=_i32(graph.row_offsets[src + 1] - graph.row_offsets[src]),
        fvalid=jnp.bool_(True), use_pull=jnp.bool_(False),
        unexplored=jnp.float32(graph.num_edges),
        stats=init_stats(),
    )


def _bfs_loop(graph: DeviceGraph, state, upto: jax.Array, *,
              fcap: int, caps: tuple[int, ...], mark_preds: bool,
              direction_optimized: bool, alpha: float, beta: float,
              init: bool = False):
    """Traversal rounds until convergence or ``upto`` iterations —
    bounded so the host can enact deep traversals in chunks (the
    reference's enactor shape). With
    ``init=True`` the first argument is the source vertex and the state
    is built in-graph (keeps the first chunk a single dispatch)."""
    if init:
        state = _bfs_init(graph, state, fcap, mark_preds)
    push = _make_push_branch(graph, fcap, mark_preds,
                             may_rebuild=direction_optimized)
    # Deep micro-loop: on by default (GUNROCK_BFS_DEEP=0 disables);
    # GUNROCK_BFS_DEEP_RUNGS="512,2048,8192" builds one micro-loop per
    # rung (see _deep_rungs).
    deeps = []
    if os.environ.get("GUNROCK_BFS_DEEP", "1") == "1":
        deeps = [(c, _make_deep_loop(graph, fcap, mark_preds, upto, C=c))
                 for c in _deep_rungs("GUNROCK_BFS_DEEP_RUNGS", DEEP_CAP)
                 if fcap >= c]
    deep = deeps[-1][1] if deeps else None
    deep_cap_max = deeps[-1][0] if deeps else DEEP_CAP

    def _general_level(state: _State, m_f):
        dispatch_size = jnp.maximum(m_f, state.n)
        (labels, preds, frontier, n, m_f_next, fvalid, edges,
         overflow) = dispatch_by_size(dispatch_size, caps, push, state)
        stats = record_iteration(state.stats, frontier_len=n, edges=edges,
                                 overflow=overflow)
        return _State(
            labels=labels, preds=preds, frontier=frontier, n=n,
            m_f=m_f_next, fvalid=fvalid, use_pull=state.use_pull,
            unexplored=state.unexplored - m_f.astype(jnp.float32),
            stats=stats,
        )

    def cond(state: _State):
        return (state.n > 0) & (state.stats.iteration < upto) & \
               (~state.stats.overflow)

    def _do_level(state: _State, m_f):
        dispatch_size = jnp.maximum(m_f, state.n)
        # Direction vote (reference per-GPU votes with do_a/do_b
        # thresholds, bfs_enactor.cuh:852-939,1829-1830). Beamer's
        # asymmetric hysteresis assumes pull cost ~ unexplored edges and
        # push cost ~ frontier count; our pull pass is a FLAT full-edge
        # sweep while push cost scales with frontier-edge lanes, so the
        # pull-ENTRY decision is memoryless in m_f alone: pull iff the
        # frontier's edge volume exceeds the break-even threshold.
        # ``alpha`` keeps its Beamer direction (bigger = pull more).
        # With the queue unmaterialized (fvalid=False) a push must
        # first pay a v-scale lazy rebuild, so the pull threshold
        # drops sharply there. The constants are not yet fitted to
        # the GPU.
        # ``beta`` is the Beamer/reference do_b pull-EXIT knob: once in
        # pull mode, stay there while the frontier is still wide
        # (n > V/beta) even if its edge volume dips under the entry
        # threshold — switching back early pays the queue rebuild just
        # to switch forward again (bigger beta = leave pull sooner).
        thresh = jnp.where(state.fvalid,
                           jnp.float32(graph.num_edges / 32.0),
                           jnp.float32(graph.num_edges / 4096.0))
        vote = m_f.astype(jnp.float32) * jnp.float32(alpha) > thresh
        sticky = state.use_pull & (
            state.n.astype(jnp.float32) * jnp.float32(beta) >
            jnp.float32(graph.num_nodes))
        use_pull = vote | sticky
        (labels, preds, frontier, n, m_f_next, fvalid, edges,
         overflow) = jax.lax.cond(
            use_pull,
            lambda s: _pull_step(graph, fcap, mark_preds, s),
            lambda s: dispatch_by_size(dispatch_size, caps, push, s),
            state,
        )
        stats = record_iteration(state.stats, frontier_len=n, edges=edges,
                                 overflow=overflow)
        return _State(
            labels=labels, preds=preds, frontier=frontier, n=n,
            m_f=m_f_next, fvalid=fvalid, use_pull=use_pull,
            unexplored=state.unexplored - m_f.astype(jnp.float32),
            stats=stats,
        )

    def _deep_entry(state: _State, d=None):
        # Pull levels (and the single-source fast path) leave the queue
        # unmaterialized; the micro-loop needs a real queue — rebuild it
        # once per stretch from the label mask (v-scale, amortized over
        # the whole stretch of tiny levels).
        cur = state.stats.iteration
        frontier0, n0 = jax.lax.cond(
            state.fvalid,
            lambda: (state.frontier, state.n),
            lambda: frontier_from_mask(state.labels == cur, fcap),
        )
        st = dataclasses.replace(state, frontier=frontier0, n=n0,
                                 fvalid=jnp.bool_(True),
                                 use_pull=jnp.bool_(False))
        return (deep if d is None else d)(st)

    def _deep_dispatch(state: _State):
        # Smallest micro rung that fits this stretch's entry size; the
        # rung's own micro_cond spills back out when the wavefront
        # outgrows it (chained conds, stretch granularity).
        ds = jnp.maximum(state.m_f, state.n)

        def level(i):
            if i == len(deeps) - 1:
                return lambda s: _deep_entry(s, deeps[i][1])
            return lambda s: jax.lax.cond(
                ds <= deeps[i][0],
                lambda ss: _deep_entry(ss, deeps[i][1]),
                level(i + 1), s)

        return level(0)(state)

    def body(state: _State):
        m_f = state.m_f
        # rung must bound the frontier LENGTH too (outdeg-0 vertices can
        # make n exceed m_f on directed graphs)
        dispatch_size = jnp.maximum(m_f, state.n)

        if direction_optimized:
            # Deep-graph regime beats the direction vote outright: at
            # m_f <= DEEP_CAP a pull pass is a full-edge sweep for a
            # few-thousand-edge level, and even the general push rung
            # pays ladder/claim-table overheads — road-class graphs
            # (the CLI default runs DO) live here almost entirely.
            if deep is not None:
                return jax.lax.cond(
                    dispatch_size <= deep_cap_max, _deep_dispatch,
                    lambda s: _do_level(s, m_f), state)
            return _do_level(state, m_f)
        if deep is not None:
            # Deep-graph regime: a whole stretch of tiny levels runs
            # in the rung-scale micro-loop; this body only sees the
            # levels whose frontiers outgrow it.
            return jax.lax.cond(
                dispatch_size <= deep_cap_max, _deep_dispatch,
                lambda s: _general_level(s, m_f), state)
        return _general_level(state, m_f)

    out = jax.lax.while_loop(cond, body, state)
    # Single packed convergence probe: one host fetch per chunk instead
    # of several scalar device-to-host round-trips. m_f and
    # use_pull ride along so instrumented mode can attribute each
    # iteration to its phase (pull pass / push ladder / deep micro-loop)
    # with zero extra fetches — the per-kernel duty split of the
    # reference's --instrumented mode (util/kernel_runtime_stats.cuh).
    probe = jnp.stack([out.stats.iteration,
                       out.stats.overflow.astype(jnp.int32), out.n,
                       out.m_f, out.use_pull.astype(jnp.int32)])
    return out, probe


_bfs_jit = jax.jit(
    _bfs_loop,
    static_argnames=("fcap", "caps", "mark_preds", "direction_optimized",
                     "alpha", "beta", "init"),
)


def bfs_device(graph: DeviceGraph, src, *, mark_preds: bool = False,
               direction_optimized: bool = False, alpha: float = 15.0,
               beta: float = 18.0, queue_sizing: float = 1.0,
               max_iters: Optional[int] = None,
               chunk_iters: int = 16384,
               instrument: Optional[list] = None):
    """Jit-compiled BFS on an already-uploaded graph; returns device arrays
    ``(labels, preds, stats, edges_visited)``.

    ``instrument``: pass a list to enact one iteration per device call and
    collect per-iteration wall-clock records ``{iteration, ms, frontier,
    pull, phase}`` into it — the reference's ``--instrumented``
    kernel-stats mode (``util/kernel_runtime_stats.cuh``; per-stage
    timers ``enactor_types.cuh:67-72``). ``phase`` attributes the
    iteration to the kernel family that ran it: ``"pull"`` (full-edge
    pull pass), ``"push"`` (laddered push rung) or ``"deep"``
    (micro-loop stretch). Adds per-call dispatch overhead, exactly like
    the reference's instrumented runs."""
    if direction_optimized and not graph.has_csc:
        raise ValueError("direction_optimized BFS needs to_device(with_csc=True)")
    # DO mode never materializes large (pull) frontiers as queues, so the
    # queue only needs capacity for push-mode frontiers (bounded by the
    # direction vote); a small queue keeps every push-branch frontier op
    # off the V-scale. Overflow falls back via the overflow flag.
    base_cap = graph.v_pad // 4 if direction_optimized else graph.v_pad
    fcap = max(128, min(int(base_cap * queue_sizing), graph.v_pad))
    out_cap = max(128, min(int(graph.e_pad * min(queue_sizing, 1.0)),
                           graph.e_pad))
    caps = tuple(capacity_ladder(out_cap))
    if max_iters is None:
        max_iters = graph.num_nodes + 1

    def chunk(st, upto, first):
        return _bfs_jit(
            graph, st, jnp.int32(upto),
            fcap=fcap, caps=caps, mark_preds=mark_preds,
            direction_optimized=direction_optimized,
            alpha=alpha, beta=beta, init=first)

    if instrument is not None:
        chunk_iters = 1
    # Chunked enactment: one bounded while_loop per device call; the
    # convergence probe is one packed scalar fetch per chunk, and the
    # default chunk covers any realistic BFS depth in a single call.
    import time as _time
    t0 = _time.perf_counter()
    deep_on = fcap >= DEEP_CAP
    if instrument is not None:
        # dispatch size the FIRST iteration saw: n=1, m_f=deg(src)
        prev_dispatch = int(np.asarray(
            graph.row_offsets[int(src) + 1] - graph.row_offsets[int(src)]))
        prev_dispatch = max(prev_dispatch, 1)
    upto = min(chunk_iters, max_iters)
    state, probe = chunk(jnp.int32(src), upto, True)
    while upto < max_iters:
        it, ovf, n, m_f, pull = (int(x) for x in np.asarray(probe))
        if instrument is not None:
            t1 = _time.perf_counter()
            # Phase = the branch body() dispatched on the PRE-iteration
            # dispatch size (carried from the previous probe).
            if deep_on and prev_dispatch <= DEEP_CAP and not (
                    direction_optimized and pull):
                phase = "deep"
            elif direction_optimized and pull:
                phase = "pull"
            else:
                phase = "push"
            instrument.append({
                "iteration": it, "ms": (t1 - t0) * 1e3,
                "frontier": n, "phase": phase, "pull": bool(pull)})
            t0 = t1
            prev_dispatch = max(m_f, n)
        if it < upto or ovf or n == 0:
            break
        upto = min(upto + chunk_iters, max_iters)
        state, probe = chunk(state, upto, False)
    preds_out = state.preds
    if mark_preds and direction_optimized:
        preds_out = jax.jit(_fill_preds)(graph, state.labels, state.preds)
    return state.labels, preds_out, state.stats


def bfs(graph: Union[CsrGraph, DeviceGraph], src: Union[int, str] = 0, *,
        mark_preds: bool = False, direction_optimized: bool = False,
        alpha: float = 15.0, beta: float = 18.0,
        queue_sizing: float = 1.0, max_iters: Optional[int] = None,
        idempotence: bool = False, instrumented: bool = False) -> BfsResult:
    """Run BFS from ``src`` and return host results + run record.

    API parity with the reference C entry point ``gunrock_bfs``
    (``gunrock/gunrock.h:173``, ``app/bfs/bfs_app.cu:393``).
    ``idempotence`` is accepted for parity but is a no-op (see module doc).
    ``instrumented`` collects per-iteration timing/direction records into
    ``info["per_iteration"]`` (reference ``--instrumented``).
    """
    del idempotence
    timer = Timer()
    per_iter: Optional[list] = [] if instrumented else None
    num_nodes = graph.num_nodes
    if isinstance(graph, CsrGraph):
        if src == "largestdegree":
            src = graph.largest_degree_vertex()
        with timer.time("preprocess_ms"):
            dgraph = to_device(graph, with_csc=direction_optimized)
    else:
        dgraph = graph
    src = int(src)
    if not 0 <= src < num_nodes:
        raise ValueError(f"src {src} out of range [0, {num_nodes})")

    with timer.time("process_ms"):
        # Frontier-overflow auto-regrow (reference Check_Size/EnsureSize,
        # enactor_helper.cuh:103): retry with a doubled queue sizing.
        sizing = queue_sizing
        while True:
            labels, preds, stats = jax.block_until_ready(
                bfs_device(dgraph, src, mark_preds=mark_preds,
                           direction_optimized=direction_optimized,
                           alpha=alpha, beta=beta, queue_sizing=sizing,
                           max_iters=max_iters, instrument=per_iter))
            if not bool(stats.overflow) or sizing >= 4.0:
                break
            sizing = min(sizing * 2.0, 4.0)
            if per_iter is not None:
                per_iter.clear()

    labels_np = np.asarray(labels)[:num_nodes]
    preds_np = np.asarray(preds)[:num_nodes] if mark_preds else None
    # Edges visited = out-degree sum over reached vertices (the reference's
    # DOBFS edges_visited accounting for m_teps, util/info.cuh:1431);
    # exact int64 math done host-side.
    degs = np.asarray(dgraph.row_offsets[1:num_nodes + 1]).astype(np.int64) \
        - np.asarray(dgraph.row_offsets[:num_nodes]).astype(np.int64)
    edges_visited = int(degs[labels_np >= 0].sum())
    info = make_info(
        primitive="bfs", graph=dgraph, stats=stats, timer=timer,
        edges_visited=edges_visited,
        extra={"src": src, "mark_predecessors": mark_preds,
               "direction_optimized": direction_optimized,
               "instrumented": instrumented,
               "search_depth": int(labels_np.max(initial=0)),
               **({"per_iteration": per_iter} if instrumented else {})},
    )
    return BfsResult(labels=labels_np, preds=preds_np, info=info)
