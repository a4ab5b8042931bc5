"""WTF — "Who To Follow" (Twitter recommendation).

JAX rebuild of the reference WTF primitive
(``gunrock/app/wtf/{wtf_problem,wtf_enactor,wtf_functor}.cuh``), three
phases exactly as the reference chains them (``wtf_enactor.cuh:236-565``):

  1. **Personalized PageRank** from ``src``:
     ``rank' = delta * (Σ rank[u]/outdeg(u)) + (1-delta)*[v == src]``
     (PrFunctor ApplyEdge ``wtf_functor.cuh:91`` + CondFilter ``:118``),
     iterated to threshold / max_iters.
  2. **Circle of trust**: top ``cot_size = min(1000, V)`` vertices by PPR
     rank (CUB radix sort -> ``jax.lax.top_k``); one advance from the CoT
     counts each vertex's incoming edges from the CoT
     (CotFunctor ``:219`` atomicAdd in_degrees).
  3. **Personalized SALSA** for ``1/alpha`` iterations over edges leaving
     the CoT (``wtf_enactor.cuh:464``):
       refscore'[d] = Σ rank[s]/outdeg(s)                (AUTH, ``:365``)
       rank'[s]     = Σ [s==src]*alpha/outdeg(s)
                      + (1-alpha)*refscore[d]/cot_indeg(d) (HUB, ``:350``)

  Output = vertices ranked by final refscore (descending).
"""

from __future__ import annotations

import dataclasses
from typing import Union

import jax
import jax.numpy as jnp
import numpy as np

from ..enactor import Timer, capacity_ladder, dispatch_by_size
from ..graph.csr import CsrGraph
from ..ops.segment import row_reduce_sorted
from ..graph.device import DeviceGraph, to_device
from ..ops.advance import expand
from ..ops.segment import scatter_add
from ..utils.info import make_info

__all__ = ["wtf", "WtfResult", "wtf_device"]

COT_SIZE = 1000  # reference wtf_enactor.cuh:398


@dataclasses.dataclass
class WtfResult:
    node_ids: np.ndarray    # recommended vertices, best first
    scores: np.ndarray      # their refscores
    ppr_ranks: np.ndarray   # (V,) personalized PageRank from phase 1
    info: dict


def _wtf_phase12(graph: DeviceGraph, src: jax.Array, max_iters: jax.Array,
                 threshold: jax.Array, *, delta: float, cot_cap: int):
    v_pad = graph.v_pad
    vmask = jnp.arange(v_pad, dtype=jnp.int32) < graph.num_nodes
    out_deg = (graph.row_offsets[1:] - graph.row_offsets[:-1]).astype(jnp.float32)
    inv_out = jnp.where(out_deg > 0, 1.0 / jnp.maximum(out_deg, 1.0), 0.0)
    is_src = jnp.arange(v_pad, dtype=jnp.int32) == src

    # ---- phase 1: personalized PageRank
    rank0 = jnp.where(vmask, 1.0 / graph.num_nodes, 0.0).astype(jnp.float32)

    def pr_cond(carry):
        rank, diff, it = carry
        return (diff > threshold) & (it < max_iters)

    def pr_body(carry):
        rank, _, it = carry
        incoming = row_reduce_sorted((rank * inv_out)[graph.csc_indices],
                                     graph.csc_offsets, op="sum")
        new_rank = delta * incoming + (1.0 - delta) * is_src
        new_rank = jnp.where(vmask, new_rank, 0.0)
        return new_rank, jnp.sum(jnp.abs(new_rank - rank)), it + 1

    ppr, _, ppr_iters = jax.lax.while_loop(
        pr_cond, pr_body, (rank0, jnp.float32(jnp.inf), jnp.int32(0)))

    # ---- phase 2: circle of trust = top-k by PPR rank
    top_vals, cot = jax.lax.top_k(jnp.where(vmask, ppr, -1.0), cot_cap)
    cot = cot.astype(jnp.int32)
    n_cot = jnp.int32(min(COT_SIZE, graph.num_nodes, cot_cap))
    lane = jnp.arange(cot_cap, dtype=jnp.int32)
    valid = lane < n_cot
    cot_deg = jnp.sum(jnp.where(
        valid, graph.row_offsets[cot + 1] - graph.row_offsets[cot], 0))
    return ppr, ppr_iters, cot, cot_deg


def _wtf_phase3(graph: DeviceGraph, src: jax.Array, cot: jax.Array,
                *, alpha: float, cot_cap: int, cap: int):
    v_pad = graph.v_pad
    vmask = jnp.arange(v_pad, dtype=jnp.int32) < graph.num_nodes
    out_deg = (graph.row_offsets[1:] - graph.row_offsets[:-1]).astype(jnp.float32)
    inv_out = jnp.where(out_deg > 0, 1.0 / jnp.maximum(out_deg, 1.0), 0.0)
    n_cot = jnp.int32(min(COT_SIZE, graph.num_nodes, cot_cap))

    ex = expand(graph, cot, n_cot, cap)
    esrc, edst, emask = ex.src, ex.dst, ex.mask
    cot_indeg = scatter_add(jnp.zeros((v_pad,), jnp.float32), edst,
                            jnp.ones_like(edst, jnp.float32), mask=emask)
    inv_cot_in = jnp.where(cot_indeg > 0, 1.0 / jnp.maximum(cot_indeg, 1.0),
                           0.0)

    # ---- phase 3: personalized SALSA over the CoT's out-edges
    salsa_iters = jnp.int32(1.0 / alpha)
    rank0 = jnp.zeros((v_pad,), jnp.float32).at[src].set(1.0)
    ref0 = jnp.zeros((v_pad,), jnp.float32)

    def s_body(i, carry):
        rank, ref = carry
        ref = scatter_add(jnp.zeros((v_pad,), jnp.float32), edst,
                          (rank * inv_out)[esrc], mask=emask)
        hub_val = jnp.where(esrc == src, alpha * inv_out[esrc], 0.0) + \
            (1.0 - alpha) * (ref * inv_cot_in)[edst]
        rank = scatter_add(jnp.zeros((v_pad,), jnp.float32), esrc, hub_val,
                           mask=emask)
        return rank, ref

    _, refscore = jax.lax.fori_loop(0, salsa_iters, s_body, (rank0, ref0))
    scores, node_ids = jax.lax.top_k(jnp.where(vmask, refscore, -1.0),
                                     cot_cap)
    return node_ids.astype(jnp.int32), scores


_wtf_p12_jit = jax.jit(
    _wtf_phase12, static_argnames=("delta", "cot_cap"))
_wtf_p3_jit = jax.jit(
    _wtf_phase3, static_argnames=("alpha", "cot_cap", "cap"))


def wtf_device(graph: DeviceGraph, src, *, delta: float = 0.85,
               alpha: float = 0.2, max_iters: int = 50,
               threshold: float = 1e-6):
    if not graph.has_csc:
        raise ValueError("WTF needs to_device(with_csc=True)")
    cot_cap = min(COT_SIZE, graph.num_nodes)
    caps = capacity_ladder(graph.e_pad)
    ppr, ppr_iters, cot, cot_deg = _wtf_p12_jit(
        graph, jnp.int32(src), jnp.int32(max_iters),
        jnp.float32(threshold), delta=float(delta), cot_cap=cot_cap)
    # Pick the phase-3 edge capacity on the host (one scalar fetch) —
    # switch branches can't return rung-sized edge lists.
    cd = int(np.asarray(cot_deg))
    cap = next((c for c in caps if c >= cd), caps[-1])
    node_ids, scores = _wtf_p3_jit(graph, jnp.int32(src), cot,
                                   alpha=float(alpha), cot_cap=cot_cap,
                                   cap=cap)
    return node_ids, scores, ppr, ppr_iters


def wtf(graph: Union[CsrGraph, DeviceGraph], src: int = 0, *,
        delta: float = 0.85, alpha: float = 0.2, max_iters: int = 50,
        threshold: float = 1e-6) -> WtfResult:
    timer = Timer()
    if not 0 <= int(src) < graph.num_nodes:
        raise ValueError(f"src {src} out of range [0, {graph.num_nodes})")
    if isinstance(graph, CsrGraph):
        with timer.time("preprocess_ms"):
            dgraph = to_device(graph, with_csc=True)
    else:
        dgraph = graph
    with timer.time("process_ms"):
        node_ids, scores, ppr, ppr_iters = jax.block_until_ready(
            wtf_device(dgraph, src, delta=delta, alpha=alpha,
                       max_iters=max_iters, threshold=threshold))
    info = make_info(
        primitive="wtf", graph=dgraph, timer=timer,
        edges_visited=dgraph.num_edges * int(ppr_iters),
        extra={"src": int(src), "delta": delta, "alpha": alpha,
               "ppr_iterations": int(ppr_iters)},
    )
    return WtfResult(node_ids=np.asarray(node_ids),
                     scores=np.asarray(scores),
                     ppr_ranks=np.asarray(ppr)[:graph.num_nodes],
                     info=info)
