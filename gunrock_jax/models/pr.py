"""PageRank.

JAX rebuild of the reference PR primitive
(``gunrock/app/pr/{pr_problem,pr_enactor,pr_functor}.cuh``): the reference
runs a full-frontier push of ``rank/degree`` along every edge per iteration
(HAS_FULLQ, ``pr_enactor.cuh:326-341``), converging when no vertex's rank
moved more than ``threshold`` (``pr_problem.cuh:83-93``, Stop_Condition
``pr_enactor.cuh:864-884``). Here the same computation is a pull-mode
SpMV over the CSC — a sorted segmented sum over the in-edges — with the
per-vertex convergence mask preserved.

Supports the reference's ``normalized`` toggle:
  normalized:   rank' = (1-d)/V + d * Σ rank[u]/deg[u]
  plain:        rank' = (1-d)   + d * Σ rank[u]/deg[u]
and the compensation for dangling vertices in normalized mode (scaled
redistribution) is available via ``compensate=True``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..enactor import LoopStats, Timer, init_stats, record_iteration
from ..graph.csr import CsrGraph
from ..ops.segment import row_reduce_sorted
from ..graph.device import DeviceGraph, to_device
from ..utils.info import make_info

__all__ = ["pagerank", "PageRankResult", "pagerank_device"]


@dataclasses.dataclass
class PageRankResult:
    ranks: np.ndarray        # (V,) float32
    node_ids: np.ndarray     # (V,) int32 vertices sorted by descending rank
    info: dict


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["rank", "num_updated", "stats"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class _State:
    rank: jax.Array         # (v_pad,) float32
    num_updated: jax.Array  # () int32
    stats: LoopStats


def _pr_loop(graph: DeviceGraph, state, max_iters: jax.Array,
             threshold: jax.Array, *, damping: float, normalized: bool,
             compensate: bool, init: bool = False):
    v_pad = graph.v_pad
    n = graph.num_nodes
    vmask = jnp.arange(v_pad, dtype=jnp.int32) < n
    deg = (graph.row_offsets[1:] - graph.row_offsets[:-1]).astype(jnp.float32)
    inv_deg = jnp.where(deg > 0, 1.0 / jnp.maximum(deg, 1.0), 0.0)
    init_rank = jnp.where(vmask, (1.0 / n) if normalized else 1.0 - damping,
                          0.0).astype(jnp.float32)
    reset = jnp.float32((1.0 - damping) / n if normalized else 1.0 - damping)
    if init:
        state = _State(rank=init_rank, num_updated=jnp.int32(1),
                       stats=init_stats())

    def cond(state: _State):
        return (state.num_updated > 0) & (state.stats.iteration < max_iters)

    def body(state: _State):
        contrib = state.rank * inv_deg
        edge_vals = contrib[graph.csc_indices]
        # Padded CSC slots lie beyond every row end, so the scan-based
        # reduction drops them without masking.
        incoming = row_reduce_sorted(edge_vals, graph.csc_offsets, op="sum")
        new_rank = reset + damping * incoming
        if normalized and compensate:
            # Redistribute dangling-vertex mass uniformly.
            dangling = jnp.sum(jnp.where(vmask & (deg == 0), state.rank, 0.0))
            new_rank = new_rank + damping * dangling / n
        new_rank = jnp.where(vmask, new_rank, 0.0)
        updated = vmask & (jnp.abs(new_rank - state.rank) > threshold)
        num_updated = jnp.sum(updated.astype(jnp.int32))
        stats = record_iteration(
            state.stats, frontier_len=num_updated,
            edges=jnp.int32(min(graph.num_edges, 2**31 - 1)))
        return _State(rank=new_rank, num_updated=num_updated, stats=stats)

    final = jax.lax.while_loop(cond, body, state)
    probe = jnp.stack([final.stats.iteration, final.num_updated])
    return final, probe


@partial(jax.jit, static_argnames=())
def _pr_extract(state: _State):
    order = jnp.argsort(-state.rank)  # descending rank (reference PR app
    # outputs (node_id, rank) sorted by rank, app/pr/pr_app.cu)
    return state.rank, order.astype(jnp.int32)


_pr_jit = jax.jit(
    _pr_loop,
    static_argnames=("damping", "normalized", "compensate", "init"),
)


def pagerank_device(graph: DeviceGraph, *, damping: float = 0.85,
                    threshold: float = 1e-6, max_iters: int = 50,
                    normalized: bool = True, compensate: bool = False,
                    instrument: Optional[list] = None):
    """``instrument``: pass a list to run one iteration per device call
    and collect per-iteration wall/updated records (reference
    ``--instrumented``)."""
    if not graph.has_csc:
        raise ValueError("PageRank needs to_device(with_csc=True)")

    def chunk(st, upto, first):
        return _pr_jit(graph, st, jnp.int32(upto), jnp.float32(threshold),
                       damping=float(damping), normalized=normalized,
                       compensate=compensate, init=first)

    if instrument is None:
        state, _ = chunk(None, max_iters, True)
    else:
        import time as _time
        t0 = _time.perf_counter()
        state, probe = chunk(None, 1, True)
        while True:
            it, num_updated = (int(x) for x in np.asarray(probe))
            t1 = _time.perf_counter()
            instrument.append({"iteration": it, "ms": (t1 - t0) * 1e3,
                               "updated": num_updated})
            t0 = t1
            if num_updated == 0 or it >= max_iters:
                break
            state, probe = chunk(state, it + 1, False)
    rank, order = _pr_extract(state)
    return rank, order, state.stats


def pagerank(graph: Union[CsrGraph, DeviceGraph], *, damping: float = 0.85,
             threshold: float = 1e-6, max_iters: int = 50,
             normalized: bool = True, compensate: bool = False,
             instrumented: bool = False) -> PageRankResult:
    """C API parity: ``gunrock_pagerank`` (``gunrock.h:311``)."""
    timer = Timer()
    per_iter: Optional[list] = [] if instrumented else None
    num_nodes = graph.num_nodes
    if isinstance(graph, CsrGraph):
        with timer.time("preprocess_ms"):
            dgraph = to_device(graph, with_csc=True)
    else:
        dgraph = graph

    with timer.time("process_ms"):
        rank, order, stats = jax.block_until_ready(
            pagerank_device(dgraph, damping=damping, threshold=threshold,
                            max_iters=max_iters, normalized=normalized,
                            compensate=compensate, instrument=per_iter))

    ranks_np = np.asarray(rank)[:num_nodes]
    order_np = np.asarray(order)
    order_np = order_np[order_np < num_nodes][:num_nodes]
    iters = int(stats.iteration)
    info = make_info(
        primitive="pagerank", graph=dgraph, stats=stats, timer=timer,
        edges_visited=int(dgraph.num_edges) * iters,
        extra={"damping": damping, "threshold": threshold,
               "max_iteration": max_iters, "normalized": normalized,
               "instrumented": instrumented,
               "search_depth": iters,
               **({"per_iteration": per_iter} if instrumented else {})},
    )
    return PageRankResult(ranks=ranks_np, node_ids=order_np, info=info)
