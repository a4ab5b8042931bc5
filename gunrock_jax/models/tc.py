"""Triangle counting via segmented intersection.

The reference documents segmented intersection as its fourth operator
(``doc/programming_model.md`` "Operators", for triangle counting) but the
CUDA implementation is absent from the snapshot (only ``util/join.cuh``
leftovers). This is the complete primitive:

  1. orient the undirected graph into a DAG by (degree, id) order —
     the standard forward/node-iterator trick that bounds the oriented
     out-degree by O(sqrt(E));
  2. one :func:`gunrock_jax.ops.intersection.intersect_counts` call:
     merge-path wedge expansion + binary-search edge probes;
  3. triangle total = sum of per-edge intersection counts (each triangle
     counted exactly once in the DAG).
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial
from typing import Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..enactor import Timer
from ..graph.csr import CsrGraph, from_coo
from ..graph.device import round_up
from ..ops.intersection import intersect_counts
from ..utils.info import make_info

__all__ = ["tc", "TcResult", "tc_device"]


@dataclasses.dataclass
class TcResult:
    total: int                    # number of triangles in the graph
    edge_counts: np.ndarray       # per-oriented-edge intersection sizes
    vertex_counts: np.ndarray     # triangles incident to each vertex
    info: dict


@partial(jax.jit, static_argnames=("wedge_cap",))
def tc_device(row_offsets: jax.Array, col_indices: jax.Array,
              edge_src: jax.Array, chunk_src: jax.Array,
              chunk_dst: jax.Array, *, num_edges, wedge_cap: int):
    """Per-edge triangle counts for one edge chunk of an oriented CSR.

    ``num_edges`` is a TRACED scalar: chunks have different live edge
    counts, and making it static would recompile the whole sort-join
    graph once per chunk."""
    counts, vcounts, wedges = intersect_counts(
        row_offsets, col_indices, edge_src, chunk_src, chunk_dst,
        jnp.asarray(num_edges, jnp.int32), wedge_cap)
    return counts, vcounts, jnp.sum(counts, dtype=jnp.int32), wedges


def _orient(g: CsrGraph) -> CsrGraph:
    """Degree-order DAG orientation: keep (u, v) iff u precedes v in
    (degree, id) order. Assumes a symmetrized simple graph."""
    deg = g.out_degrees
    src = g.edge_sources()
    dst = g.col_indices
    lt = (deg[src] < deg[dst]) | ((deg[src] == deg[dst]) & (src < dst))
    return from_coo(g.num_nodes, src[lt], dst[lt],
                    remove_self_loops=False, dedup=False)


@dataclasses.dataclass
class _TcPrep:
    """Host-side oriented-DAG layout + wedge-budget chunking, shared by
    the single-chip chunk loop and the chunk-parallel sharded TC
    (``parallel/tc.py``)."""
    dag: CsrGraph
    row: np.ndarray          # (v_pad+1,) int32
    col: np.ndarray          # (e_pad,) int32, pad lanes = v_pad
    esrc_pad: np.ndarray     # (e_pad,) int32, pad lanes = v_pad
    esrc_full: np.ndarray    # (num_edges,) int32
    bounds: list             # chunk edge boundaries
    chunk_e: int
    wedge_cap: int
    wedge_total: int
    v_pad: int


def _default_wedge_budget() -> int:
    """Per-chunk wedge cap. One chunk is one device call whose dominant
    cost is a (e_pad + wedge_cap)-lane multi-key sort; the cap bounds its
    memory and time. Not yet tuned on the GPU. Override:
    GUNROCK_TC_WEDGE_BUDGET."""
    env = os.environ.get("GUNROCK_TC_WEDGE_BUDGET")
    if env:
        return int(env)
    return 1 << 26


def _tc_prepare(g: CsrGraph, wedge_budget: Optional[int] = None) -> _TcPrep:
    if wedge_budget is None:
        wedge_budget = _default_wedge_budget()
    dag = _orient(g)
    deg = np.diff(dag.row_offsets).astype(np.int64)
    per_edge_wedges = deg[dag.col_indices]
    wedge_total = int(per_edge_wedges.sum())
    v_pad = round_up(max(dag.num_nodes, 1))
    row = np.full(v_pad + 1, dag.num_edges, np.int32)
    row[: dag.num_nodes + 1] = dag.row_offsets.astype(np.int32)
    e_pad = round_up(max(dag.num_edges, 1))
    col = np.full(e_pad, v_pad, np.int32)
    col[: dag.num_edges] = dag.col_indices
    esrc_full = dag.edge_sources().astype(np.int32)
    # Global per-edge sources for the sort-join probe set; pad lanes
    # pin to v_pad so they can never match a wedge.
    esrc_pad = np.full(e_pad, v_pad, np.int32)
    esrc_pad[: dag.num_edges] = esrc_full
    # Chunk edges so each chunk's wedge count fits the budget.
    wcum = np.concatenate([[0], np.cumsum(per_edge_wedges)])
    bounds = [0]
    while bounds[-1] < dag.num_edges:
        nxt = int(np.searchsorted(
            wcum, wcum[bounds[-1]] + wedge_budget, side="right")) - 1
        bounds.append(min(max(nxt, bounds[-1] + 1), dag.num_edges))
    chunk_e = round_up(max(max(b - a for a, b in
                               zip(bounds, bounds[1:])), 1))
    wedge_cap = round_up(int(max(
        (wcum[b] - wcum[a] for a, b in zip(bounds, bounds[1:])),
        default=1)) or 1)
    return _TcPrep(dag=dag, row=row, col=col, esrc_pad=esrc_pad,
                   esrc_full=esrc_full, bounds=bounds, chunk_e=chunk_e,
                   wedge_cap=wedge_cap, wedge_total=wedge_total,
                   v_pad=v_pad)


def tc(graph: Union[CsrGraph], *, undirected_input: bool = True) -> TcResult:
    """Count triangles. Input must be a symmetric (undirected) graph —
    pass ``undirected_input=False`` to symmetrize a directed one first."""
    timer = Timer()
    g = graph
    if not undirected_input:
        src = g.edge_sources()
        g = from_coo(g.num_nodes, src, g.col_indices, undirected=True)

    with timer.time("preprocess_ms"):
        prep = _tc_prepare(g)
        dag, row, col = prep.dag, prep.row, prep.col
        esrc_pad, esrc_full = prep.esrc_pad, prep.esrc_full
        bounds, chunk_e = prep.bounds, prep.chunk_e
        wedge_cap, wedge_total = prep.wedge_cap, prep.wedge_total

    with timer.time("process_ms"):
        rowj = jnp.asarray(row)
        colj = jnp.asarray(col)
        esrcj = jnp.asarray(esrc_pad)
        counts_np = np.zeros(dag.num_edges, np.int32)
        vcounts = np.zeros(g.num_nodes, np.int64)
        total = 0
        for a, b in zip(bounds, bounds[1:]):
            csrc = np.zeros(chunk_e, np.int32)
            cdst = np.zeros(chunk_e, np.int32)
            csrc[: b - a] = esrc_full[a:b]
            cdst[: b - a] = col[a:b]
            cc, vc, tt, _ = jax.block_until_ready(
                tc_device(rowj, colj, esrcj, jnp.asarray(csrc),
                          jnp.asarray(cdst),
                          num_edges=b - a, wedge_cap=wedge_cap))
            counts_np[a:b] = np.asarray(cc)[: b - a]
            vcounts += np.asarray(vc)[: g.num_nodes].astype(np.int64)
            total += int(tt)
    info = make_info(
        primitive="tc", graph=g, timer=timer,
        edges_visited=wedge_total,
        extra={"num_triangles": int(total),
               "wedges_probed": wedge_total,
               "num_chunks": len(bounds) - 1},
    )
    return TcResult(total=int(total), edge_counts=counts_np,
                    vertex_counts=vcounts, info=info)
