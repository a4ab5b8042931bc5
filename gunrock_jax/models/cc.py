"""Connected components (Afforest-style sampling + Soman hooking).

JAX rebuild of the reference CC primitive
(``gunrock/app/cc/{cc_problem,cc_enactor,cc_functor}.cuh``): the reference
iterates Hook{Min,Max} and PtrJump filter kernels over the full edge list
(``cc_functor.cuh:100-659``) using the ALL_EDGES advance variant
(``cc_enactor.cuh:343``). Every full-edge round pays an all-edge
irregular pass, so the enactment here uses the subgraph-sampling plan
from Afforest [Sutton/Orr/Pearce, IPDPS'18] on top of the same
Shiloach–Vishkin hook/jump primitives:

  1. *Neighbor-round linking*: hook every vertex to its first k=2 CSR
     neighbors — two vertex-scale sorted gathers instead of edge-scale
     passes. On scale-free graphs this alone collapses ~99% of edges'
     components.
  2. *Giant-component estimate*: sample 2048 vertices, take the modal
     component id ``c_hat``.
  3. *Remainder hooking*: only vertices outside ``c_hat`` (with degree > 0)
     re-examine their edges, via the capacity-ladder advance; the ladder's
     top rung degrades to the classic full-edge hook (ALL_EDGES) so
     adversarial graphs (no giant component) stay correct.

Hooks are ``comp = scatter_min(comp, max(cu,cv), min(cu,cv))``; pointer
jumping interleaves one doubling step per hook round and runs to fixpoint
at the end. Component ids are the minimum vertex id in each component
(same normal form the reference extracts). Input must be symmetrized
(the reference expects symmetric edges too).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..enactor import (LoopStats, Timer, capacity_ladder, init_stats,
                       record_iteration)
from ..graph.csr import CsrGraph
from ..graph.device import DeviceGraph, to_device
from ..ops.advance import expand
from ..ops.segment import frontier_from_mask
from ..utils.info import make_info

__all__ = ["cc", "CcResult", "cc_device"]

NEIGHBOR_ROUNDS = 2     # Afforest's k: neighbor-sample linking rounds
MODE_SAMPLES = 2048


@dataclasses.dataclass
class CcResult:
    components: np.ndarray   # (V,) int32 component id (min vertex id)
    num_components: int
    info: dict


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["comp", "c_hat", "changed", "stats"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class _State:
    comp: jax.Array     # (v_pad,) int32
    c_hat: jax.Array    # () int32 — modal (giant) component estimate
    changed: jax.Array  # () bool
    stats: LoopStats


def _hook(comp: jax.Array, cu: jax.Array, cv: jax.Array,
          active: jax.Array, v_pad: int) -> tuple[jax.Array, jax.Array]:
    """HookMin (cc_functor.cuh:235): attach the larger representative
    under the smaller; deterministic scatter-min resolves conflicts."""
    differs = active & (cu != cv)
    hi = jnp.maximum(cu, cv)
    lo = jnp.minimum(cu, cv)
    comp = comp.at[jnp.where(differs, hi, v_pad)].min(lo, mode="drop")
    return comp, differs


def _jump_fixpoint(comp: jax.Array) -> jax.Array:
    """PtrJump (cc_functor.cuh:503) to fixpoint — one v-scale gather per
    doubling round."""
    def body(st):
        c, _ = st
        cc = jnp.take(c, c)
        return cc, jnp.any(cc != c)

    c, _ = jax.lax.while_loop(lambda st: st[1], body,
                              (comp, jnp.bool_(True)))
    return c


def _full_edge_branch(graph: DeviceGraph):
    """Classic ALL_EDGES hook over every edge — the ladder's top rung."""
    v_pad = graph.v_pad

    def step(state: _State):
        lane = jnp.arange(graph.e_pad, dtype=jnp.int32)
        emask = lane < graph.num_edges
        cu = state.comp[jnp.where(emask, graph.edge_src, 0)]
        cv = state.comp[jnp.where(emask, graph.col_indices, 0)]
        comp, differs = _hook(state.comp, cu, cv, emask, v_pad)
        comp = jnp.take(comp, comp)      # one doubling step
        return comp, jnp.any(differs), \
            jnp.int32(min(graph.num_edges, 2**31 - 1))
    return step


def _make_expand_branch(graph: DeviceGraph):
    """Remainder hooking over the frontier's own edges (capacity rung)."""
    v_pad = graph.v_pad

    def make(cap: int):
        in_cap = min(cap, v_pad)

        def step(state: _State):
            comp, c_hat = state.comp, state.c_hat
            deg = graph.row_offsets[1:] - graph.row_offsets[:-1]
            fmask = (comp != c_hat) & (deg > 0) & \
                (jnp.arange(v_pad, dtype=jnp.int32) < graph.num_nodes)
            frontier, n0 = frontier_from_mask(fmask, v_pad)
            # cap >= m_f >= n0 (every frontier vertex has deg >= 1), so
            # the slice never drops active lanes.
            frontier = jax.lax.dynamic_slice(frontier, (0,), (in_cap,)) \
                if in_cap < v_pad else frontier
            n0 = jnp.minimum(n0, in_cap)
            fr = jnp.where(jnp.arange(
                frontier.shape[0], dtype=jnp.int32) < n0, frontier,
                v_pad - 1)
            ex = expand(graph, fr, n0, cap, sorted_frontier=True)
            comp_f = jnp.take(comp, fr, indices_are_sorted=True)
            cu = jnp.take(comp_f, ex.rank, indices_are_sorted=True)
            cv = comp[ex.dst]
            comp, differs = _hook(comp, cu, cv, ex.mask, v_pad)
            comp = jnp.take(comp, comp)
            return comp, jnp.any(differs), ex.total
        return step
    return make


def _cc_init(graph: DeviceGraph) -> _State:
    """Phases 1+2: neighbor-round linking + modal component estimate."""
    v_pad = graph.v_pad
    e_pad = graph.e_pad
    comp = jnp.arange(v_pad, dtype=jnp.int32)
    vmask = jnp.arange(v_pad, dtype=jnp.int32) < graph.num_nodes
    starts = graph.row_offsets[:-1]
    degs = graph.row_offsets[1:] - starts
    stats = init_stats()

    # Phase 1 — neighbor-round linking: hook v to its j-th neighbor.
    # One doubling step per hook round; no fixpoint here (the modal
    # estimate below only needs comp values to CONCENTRATE, not to be
    # canonical, and each extra v-scale random gather costs a pass).
    for j in range(NEIGHBOR_ROUNDS):
        has = (jnp.int32(j) < degs) & vmask
        nb = jnp.take(graph.col_indices,
                      jnp.minimum(starts + j, e_pad - 1),
                      indices_are_sorted=True)
        cu = comp
        cv = jnp.take(comp, jnp.where(has, nb, 0))
        comp, differs = _hook(comp, cu, cv, has, v_pad)
        comp = jnp.take(comp, comp)
        stats = record_iteration(
            stats, frontier_len=jnp.sum(differs.astype(jnp.int32)),
            edges=jnp.int32(min(graph.num_nodes, 2**31 - 1)))

    # One more doubling before the estimate: trees are depth<=2 after the
    # link rounds, so a single step lands nearly all giant members on one
    # representative value.
    comp = jnp.take(comp, comp)

    # Phase 2 — modal component estimate from a strided vertex sample.
    stride = max(1, graph.num_nodes // MODE_SAMPLES)
    sample = comp[: stride * MODE_SAMPLES: stride]
    counts = jnp.sum((sample[None, :] == sample[:, None]).astype(jnp.int32),
                     axis=1)
    c_hat = sample[jnp.argmax(counts)]
    return _State(comp=comp, c_hat=c_hat, changed=jnp.bool_(True),
                  stats=stats)


def _cc_chunk(graph: DeviceGraph, state, upto: jax.Array,
              init: bool = False):
    """Phase 3 up to iteration ``upto``: hook the remainder's edges until
    fixpoint; rung by the remainder's edge volume, degrading to the
    classic full-edge hook. Resumable for chunked/instrumented
    enactment (state in == state out)."""
    v_pad = graph.v_pad
    vmask = jnp.arange(v_pad, dtype=jnp.int32) < graph.num_nodes
    if init:
        state = _cc_init(graph)

    caps = capacity_ladder(graph.e_pad)
    branches = [_make_expand_branch(graph)(c) for c in caps[:-1]] + \
        [_full_edge_branch(graph)]
    bounds = jnp.asarray(caps[:-1], dtype=jnp.int32)

    def cond(state: _State):
        return state.changed & (state.stats.iteration < upto)

    def body(state: _State):
        deg = graph.row_offsets[1:] - graph.row_offsets[:-1]
        fmask = (state.comp != state.c_hat) & (deg > 0) & vmask
        m_f = jnp.sum(jnp.where(fmask, deg, 0))
        idx = jnp.sum((m_f > bounds).astype(jnp.int32))
        comp, changed, edges = jax.lax.switch(idx, branches, state)
        stats = record_iteration(
            state.stats,
            frontier_len=jnp.sum(fmask.astype(jnp.int32)), edges=edges)
        return _State(comp=comp, c_hat=state.c_hat, changed=changed,
                      stats=stats)

    final = jax.lax.while_loop(cond, body, state)
    probe = jnp.stack([final.stats.iteration,
                       final.changed.astype(jnp.int32)])
    return final, probe


def _cc_finalize(graph: DeviceGraph, state: _State):
    comp = _jump_fixpoint(state.comp)
    vmask = jnp.arange(graph.v_pad, dtype=jnp.int32) < graph.num_nodes
    is_root = vmask & (comp == jnp.arange(graph.v_pad, dtype=jnp.int32))
    num_components = jnp.sum(is_root.astype(jnp.int32))
    return comp, num_components


_cc_chunk_jit = jax.jit(_cc_chunk, static_argnames=("init",))
_cc_finalize_jit = jax.jit(_cc_finalize)


def cc_device(graph: DeviceGraph, *, instrument: Optional[list] = None):
    """``instrument``: pass a list to enact one phase-3 round per device
    call and collect per-round wall-clock records (reference
    ``--instrumented`` kernel stats, ``util/kernel_runtime_stats.cuh``)."""
    if graph.edge_src is None:
        raise ValueError("CC needs to_device(with_edge_src=True)")
    max_iters = 4 * graph.num_nodes + 16
    if instrument is None:
        state, _ = _cc_chunk_jit(graph, None, jnp.int32(max_iters),
                                 init=True)
    else:
        import time as _time
        t0 = _time.perf_counter()
        upto = NEIGHBOR_ROUNDS + 1
        state, probe = _cc_chunk_jit(graph, None, jnp.int32(upto),
                                     init=True)
        while True:
            it, changed = (int(x) for x in np.asarray(probe))
            t1 = _time.perf_counter()
            trace = np.asarray(state.stats.frontier_trace)
            instrument.append({
                "iteration": it, "ms": (t1 - t0) * 1e3,
                "frontier": int(trace[min(it - 1, len(trace) - 1)])})
            t0 = t1
            if not changed or it < upto or upto >= max_iters:
                break
            upto += 1
            state, probe = _cc_chunk_jit(graph, state, jnp.int32(upto),
                                         init=False)
    comp, num_components = _cc_finalize_jit(graph, state)
    return comp, num_components, state.stats


def _is_symmetric(graph: CsrGraph) -> bool:
    """Probabilistic exact symmetry check: multiset hash of per-edge
    NONLINEAR mixes of (src, dst) vs (dst, src), O(E) vectorized. The
    mix (splitmix64-style finalizer) is essential — a linear keyed sum
    collapses to comparing sum(src) vs sum(dst), a systematic collision
    class any sum-balanced asymmetric graph falls into. Residual
    collision odds ~2^-64."""
    if graph.undirected or graph.num_edges == 0:
        return True

    def mix(x: np.ndarray) -> np.ndarray:
        # splitmix64 finalizer, vectorized (public-domain constants).
        x = (x + np.uint64(0x9E3779B97F4A7C15))
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))

    a = graph.edge_sources().astype(np.uint64)
    b = graph.col_indices.astype(np.uint64)
    with np.errstate(over="ignore"):
        fwd = int(mix(a << np.uint64(32) | b).sum(dtype=np.uint64))
        rev = int(mix(b << np.uint64(32) | a).sum(dtype=np.uint64))
    return fwd == rev


def cc(graph: Union[CsrGraph, DeviceGraph], *,
       instrumented: bool = False) -> CcResult:
    """C API parity: ``gunrock_cc`` (``gunrock.h:227``). The input is
    treated as undirected connectivity (the reference expects symmetric
    edges); a directed CsrGraph is symmetrized here so the sampled
    remainder hooking (which walks out-edges only) stays correct —
    components are then weakly-connected components. ``instrumented``
    collects per-round records into ``info["per_iteration"]``."""
    timer = Timer()
    per_iter: Optional[list] = [] if instrumented else None
    num_nodes = graph.num_nodes
    symmetrized = False
    if isinstance(graph, CsrGraph):
        with timer.time("preprocess_ms"):
            if not _is_symmetric(graph):
                from ..graph.csr import from_coo
                graph = from_coo(graph.num_nodes, graph.edge_sources(),
                                 graph.col_indices, undirected=True,
                                 remove_self_loops=False)
                symmetrized = True
            dgraph = to_device(graph, with_edge_src=True)
    else:
        dgraph = graph

    with timer.time("process_ms"):
        comp, num_components, stats = jax.block_until_ready(
            cc_device(dgraph, instrument=per_iter))

    comp_np = np.asarray(comp)[:num_nodes]
    info = make_info(
        primitive="connected_components", graph=dgraph, stats=stats,
        timer=timer,
        edges_visited=int(dgraph.num_edges),
        extra={"num_components": int(num_components),
               "symmetrized": symmetrized,
               "search_depth": int(stats.iteration),
               "instrumented": instrumented,
               **({"per_iteration": per_iter} if instrumented else {})},
    )
    return CcResult(components=comp_np, num_components=int(num_components),
                    info=info)
