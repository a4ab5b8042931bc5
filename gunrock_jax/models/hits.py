"""HITS (hubs & authorities).

JAX rebuild of the reference HITS primitive
(``gunrock/app/hits/hits_enactor.cuh:158-311``): per iteration an advance
over the CSR updates authority scores from hubs and an advance over the
CSC updates hub scores from authorities, ping-ponging curr/next buffers
(the reference's "NormalizeRank" only swaps+zeroes, ``:93-113``).

Both updates are sorted segmented sums here. We additionally max-normalize
each vector per iteration (the reference's raw sums grow as
``lambda_max^k`` and overflow fp32 for larger iteration counts; relative
ordering — the primitive's output of interest — is unchanged).
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

__all__ = ["hits", "HitsResult", "hits_device"]


@dataclasses.dataclass
class HitsResult:
    hubs: np.ndarray    # (V,) float32
    auths: np.ndarray   # (V,) float32
    info: dict


def _hits_loop(graph: DeviceGraph, max_iters: jax.Array):
    v_pad = graph.v_pad
    vmask = jnp.arange(v_pad, dtype=jnp.int32) < graph.num_nodes
    hub0 = jnp.where(vmask, 1.0, 0.0).astype(jnp.float32)
    auth0 = hub0

    def body(i, carry):
        hub, auth = carry
        # auth[v] = sum of hub over in-neighbors (advance over CSC).
        auth = row_reduce_sorted(hub[graph.csc_indices],
                                 graph.csc_offsets, op="sum")
        auth = auth / jnp.maximum(jnp.max(auth), 1e-12)
        # hub[u] = sum of auth over out-neighbors (advance over CSR).
        hub = row_reduce_sorted(auth[graph.col_indices],
                                graph.row_offsets, op="sum")
        hub = hub / jnp.maximum(jnp.max(hub), 1e-12)
        return hub, auth

    hub, auth = jax.lax.fori_loop(0, max_iters, body, (hub0, auth0))
    return hub, auth


_hits_jit = jax.jit(_hits_loop)


def _hits_raw_loop(graph: DeviceGraph, src: jax.Array, delta: jax.Array,
                   max_iters: jax.Array):
    """Raw ping-pong parity mode: the reference's exact recurrence with
    NO normalization pass (its NormalizeRank only swaps + zeroes,
    ``hits_enactor.cuh:93-113``). Per iteration, both advances run V2V
    over the forward CSR (``hits_enactor.cuh:219-257``):

      auth'[u] = sum over out-edges (u,v) of hub[v] / max(outdeg v, 1)
                                       (AUTHFunctor, hits_functor.cuh:165)
      hub'[u]  = delta*[u == src]
               + (1-delta) * sum over (u,v) of auth'[v] / indeg(v)
                                       (HUBFunctor, hits_functor.cuh:91;
                the per-edge delta/outdeg[src] term sums to delta)

    with hub' reading the JUST-swapped auth' (buffer swap between the
    two advances). Contributions are degree-normalized, so raw values
    stay bounded — fp64 is unnecessary; accumulation is f32 like the
    reference's atomicAdd.
    """
    v_pad = graph.v_pad
    vmask = jnp.arange(v_pad, dtype=jnp.int32) < graph.num_nodes
    out_deg = (graph.row_offsets[1:] - graph.row_offsets[:-1]) \
        .astype(jnp.float32)
    in_deg = (graph.csc_offsets[1:] - graph.csc_offsets[:-1]) \
        .astype(jnp.float32)
    inv_out = 1.0 / jnp.maximum(out_deg, 1.0)
    inv_in = jnp.where(in_deg > 0, 1.0 / jnp.maximum(in_deg, 1.0), 0.0)
    hub0 = jnp.where(vmask, 1.0, 0.0).astype(jnp.float32)
    auth0 = hub0
    personal = delta * (jnp.arange(v_pad, dtype=jnp.int32) == src) \
        .astype(jnp.float32)

    def body(i, carry):
        hub, auth = carry
        auth = row_reduce_sorted((hub * inv_out)[graph.col_indices],
                                 graph.row_offsets, op="sum")
        hub = personal + (1.0 - delta) * row_reduce_sorted(
            (auth * inv_in)[graph.col_indices], graph.row_offsets,
            op="sum")
        return hub, auth

    return jax.lax.fori_loop(0, max_iters, body, (hub0, auth0))


_hits_raw_jit = jax.jit(_hits_raw_loop)


def hits_device(graph: DeviceGraph, max_iters: int = 50,
                mode: str = "norm", src: int = 0, delta: float = 0.2):
    """``mode="norm"`` (default): max-normalized sums — relative order
    matches the reference, values are overflow-safe. ``mode="raw"``:
    the reference's exact raw ping-pong recurrence (opt-in parity mode;
    ``src``/``delta`` are its personalization knobs,
    ``hits_problem.cuh:282-349``)."""
    if not graph.has_csc or graph.edge_src is None:
        raise ValueError("HITS needs to_device(with_csc=True, with_edge_src=True)")
    if mode == "raw":
        return _hits_raw_jit(graph, jnp.int32(src), jnp.float32(delta),
                             jnp.int32(max_iters))
    return _hits_jit(graph, jnp.int32(max_iters))


def hits(graph: Union[CsrGraph, DeviceGraph],
         max_iters: int = 50) -> HitsResult:
    timer = Timer()
    num_nodes = graph.num_nodes
    if isinstance(graph, CsrGraph):
        with timer.time("preprocess_ms"):
            dgraph = to_device(graph, with_csc=True, with_edge_src=True)
    else:
        dgraph = graph
    with timer.time("process_ms"):
        hub, auth = jax.block_until_ready(hits_device(dgraph, max_iters))
    info = make_info(
        primitive="hits", graph=dgraph, timer=timer,
        edges_visited=2 * dgraph.num_edges * max_iters,
        extra={"max_iteration": max_iters},
    )
    return HitsResult(hubs=np.asarray(hub)[:num_nodes],
                      auths=np.asarray(auth)[:num_nodes], info=info)
