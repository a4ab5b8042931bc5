"""TopK degree centrality.

JAX rebuild of the reference TopK primitive
(``gunrock/app/topk/topk_enactor.cuh:133-161``): per-vertex centrality =
out-degree + in-degree, then a top-k selection (the reference's CUB radix
sort of (node_id, degree) pairs becomes ``jax.lax.top_k``).
"""

from __future__ import annotations

import dataclasses
from typing import Union

import jax
import jax.numpy as jnp
import numpy as np

from ..enactor import Timer
from ..graph.csr import CsrGraph
from ..graph.device import DeviceGraph, to_device
from ..utils.info import make_info

__all__ = ["topk", "TopkResult", "topk_device"]


@dataclasses.dataclass
class TopkResult:
    node_ids: np.ndarray      # (k,) int32
    centralities: np.ndarray  # (k,) int32 (out_deg + in_deg)
    info: dict


def _topk(graph: DeviceGraph, k: int):
    out_deg = graph.row_offsets[1:] - graph.row_offsets[:-1]
    in_deg = graph.csc_offsets[1:] - graph.csc_offsets[:-1]
    vmask = jnp.arange(graph.v_pad, dtype=jnp.int32) < graph.num_nodes
    cent = jnp.where(vmask, out_deg + in_deg, -1)
    vals, ids = jax.lax.top_k(cent, k)
    return ids.astype(jnp.int32), vals


_topk_jit = jax.jit(_topk, static_argnames=("k",))


def topk_device(graph: DeviceGraph, k: int):
    if not graph.has_csc:
        raise ValueError("TopK needs to_device(with_csc=True)")
    return _topk_jit(graph, min(k, graph.num_nodes))


def topk(graph: Union[CsrGraph, DeviceGraph], k: int = 10) -> TopkResult:
    timer = Timer()
    if isinstance(graph, CsrGraph):
        with timer.time("preprocess_ms"):
            dgraph = to_device(graph, with_csc=True)
    else:
        dgraph = graph
    with timer.time("process_ms"):
        ids, vals = jax.block_until_ready(topk_device(dgraph, k))
    info = make_info(primitive="topk", graph=dgraph, timer=timer,
                     extra={"top_nodes": int(k)})
    return TopkResult(node_ids=np.asarray(ids),
                      centralities=np.asarray(vals), info=info)
