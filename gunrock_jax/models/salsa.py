"""SALSA (stochastic approach for link-structure analysis).

JAX rebuild of the reference SALSA primitive
(``gunrock/app/salsa/{salsa_problem,salsa_enactor,salsa_functor}.cuh``):
random-walk-normalized hub/authority propagation over CSR/CSC
(``salsa_functor.cuh:168,319`` divide by in/out degrees), ping-ponged per
iteration. As dense vector ops:

    auth[v] = Σ_{(u,v) in E}  hub[u]  / outdeg(u)
    hub[u]  = Σ_{(u,v) in E}  auth[v] / indeg(v)

which preserves total mass (each is a column-stochastic walk step).
"""

from __future__ import annotations

import dataclasses
from typing import Union

import jax
import jax.numpy as jnp
import numpy as np

from ..enactor import Timer
from ..graph.csr import CsrGraph
from ..ops.segment import row_reduce_sorted
from ..graph.device import DeviceGraph, to_device
from ..utils.info import make_info

__all__ = ["salsa", "SalsaResult", "salsa_device"]


@dataclasses.dataclass
class SalsaResult:
    hubs: np.ndarray
    auths: np.ndarray
    info: dict


def _salsa_loop(graph: DeviceGraph, max_iters: jax.Array):
    v_pad = graph.v_pad
    n = graph.num_nodes
    vmask = jnp.arange(v_pad, dtype=jnp.int32) < n
    out_deg = (graph.row_offsets[1:] - graph.row_offsets[:-1]).astype(jnp.float32)
    in_deg = (graph.csc_offsets[1:] - graph.csc_offsets[:-1]).astype(jnp.float32)
    inv_out = jnp.where(out_deg > 0, 1.0 / jnp.maximum(out_deg, 1.0), 0.0)
    inv_in = jnp.where(in_deg > 0, 1.0 / jnp.maximum(in_deg, 1.0), 0.0)
    hub0 = jnp.where(vmask, 1.0 / n, 0.0).astype(jnp.float32)
    auth0 = hub0

    def body(i, carry):
        hub, auth = carry
        auth = row_reduce_sorted((hub * inv_out)[graph.csc_indices],
                                 graph.csc_offsets, op="sum")
        hub = row_reduce_sorted((auth * inv_in)[graph.col_indices],
                                graph.row_offsets, op="sum")
        return hub, auth

    return jax.lax.fori_loop(0, max_iters, body, (hub0, auth0))


_salsa_jit = jax.jit(_salsa_loop)


def salsa_device(graph: DeviceGraph, max_iters: int = 50):
    if not graph.has_csc or graph.edge_src is None:
        raise ValueError("SALSA needs to_device(with_csc=True, with_edge_src=True)")
    return _salsa_jit(graph, jnp.int32(max_iters))


def salsa(graph: Union[CsrGraph, DeviceGraph],
          max_iters: int = 50) -> SalsaResult:
    timer = Timer()
    num_nodes = graph.num_nodes
    if isinstance(graph, CsrGraph):
        with timer.time("preprocess_ms"):
            dgraph = to_device(graph, with_csc=True, with_edge_src=True)
    else:
        dgraph = graph
    with timer.time("process_ms"):
        hub, auth = jax.block_until_ready(salsa_device(dgraph, max_iters))
    info = make_info(
        primitive="salsa", graph=dgraph, timer=timer,
        edges_visited=2 * dgraph.num_edges * max_iters,
        extra={"max_iteration": max_iters},
    )
    return SalsaResult(hubs=np.asarray(hub)[:num_nodes],
                       auths=np.asarray(auth)[:num_nodes], info=info)
