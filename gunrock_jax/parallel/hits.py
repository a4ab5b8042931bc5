"""Multi-chip HITS and SALSA: vertex-sharded dual-direction sweeps.

Beyond the reference's multi-GPU zoo (its ILoop apps cover
bfs/sssp/bc/cc/pr only); the link-analysis pair shards the same way the
sharded PageRank SpMV does (``parallel/pr.py``), but runs BOTH
directions per iteration:

  * auth[v] = sum over in-edges  (u,v) of f(hub[u])   — csc tables
  * hub[u]  = sum over out-edges (u,v) of g(auth[v])  — forward tables

Each sweep ships only boundary values over NVLink (``ghost_exchange``
with the direction's send table — the reference's forward vs backward
conversion tables, ``partitioner_base.cuh:295-383``). HITS max-
normalizes with a cross-shard ``pmax`` (single-chip parity,
``models/hits.py``); SALSA's row-stochastic updates need no
normalization (``models/salsa.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..enactor import Timer
from ..graph.csr import CsrGraph
from ..ops.segment import row_reduce_sorted
from ..utils.info import make_info
from .comm import ghost_exchange
from .mesh import AXIS, make_mesh
from .partition import PartitionedGraph, partition

__all__ = ["hits_sharded", "salsa_sharded", "ShardedLinkResult"]


@dataclasses.dataclass
class ShardedLinkResult:
    hubs: np.ndarray
    auths: np.ndarray
    info: dict


def _make_link_fn(pg: PartitionedGraph, *, kind: str, axis: str,
                  mesh: Mesh, comm_latency: int):
    S = pg.shard_size
    p = pg.num_shards
    n = pg.num_nodes
    G = pg.ghost_cap
    Gf = pg.fwd_ghost_cap

    def shard_fn(csc_off, csc_local, row_off, col_local, send_idx,
                 fwd_send_idx, vmask_local, max_iters):
        csc_off = csc_off.reshape(-1)        # (S+1,)
        csc_local = csc_local.reshape(-1)
        row_off = row_off.reshape(-1)
        col_local = col_local.reshape(-1)
        send_idx = send_idx.reshape(p, G)
        fwd_send_idx = fwd_send_idx.reshape(p, Gf)
        vmask_local = vmask_local.reshape(-1)
        lane = jnp.arange(csc_local.shape[0], dtype=jnp.int32)

        out_deg = (row_off[1:] - row_off[:-1]).astype(jnp.float32)
        in_deg = (csc_off[1:] - csc_off[:-1]).astype(jnp.float32)
        inv_out = jnp.where(out_deg > 0,
                            1.0 / jnp.maximum(out_deg, 1.0), 0.0)
        inv_in = jnp.where(in_deg > 0,
                           1.0 / jnp.maximum(in_deg, 1.0), 0.0)
        init = 1.0 if kind == "hits" else 1.0 / n
        hub0 = jnp.where(vmask_local, init, 0.0).astype(jnp.float32)

        def body(i, carry):
            hub, auth = carry
            contrib = hub if kind == "hits" else hub * inv_out
            table = ghost_exchange(axis, contrib, send_idx,
                                   comm_latency=comm_latency)
            vals = table[jnp.where(lane < csc_off[-1], csc_local, 0)]
            auth = row_reduce_sorted(vals, csc_off, op="sum")
            auth = jnp.where(vmask_local, auth, 0.0)
            if kind == "hits":
                auth = auth / jnp.maximum(
                    jax.lax.pmax(jnp.max(auth), axis), 1e-12)
            fcontrib = auth if kind == "hits" else auth * inv_in
            ftable = ghost_exchange(axis, fcontrib, fwd_send_idx,
                                    comm_latency=comm_latency)
            fvals = ftable[jnp.where(lane < row_off[-1], col_local, 0)]
            hub = row_reduce_sorted(fvals, row_off, op="sum")
            hub = jnp.where(vmask_local, hub, 0.0)
            if kind == "hits":
                hub = hub / jnp.maximum(
                    jax.lax.pmax(jnp.max(hub), axis), 1e-12)
            return hub, auth

        return jax.lax.fori_loop(0, max_iters, body, (hub0, hub0))

    in_specs = (P(AXIS, None), P(AXIS, None), P(AXIS, None), P(AXIS, None),
                P(AXIS, None, None), P(AXIS, None, None), P(AXIS), P())
    out_specs = (P(AXIS), P(AXIS))
    return jax.jit(jax.shard_map(shard_fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs))


def _link_sharded(kind: str, graph: CsrGraph, *, num_shards, max_iters,
                  partition_method, seed, mesh, comm_latency) \
        -> ShardedLinkResult:
    timer = Timer()
    if mesh is None:
        mesh = make_mesh(num_shards)
    num_shards = mesh.devices.size

    with timer.time("partition_ms"):
        pg, perm = partition(graph, num_shards, method=partition_method,
                             seed=seed, with_csc=True, with_ghosts=True)
        vmask_new = np.zeros(pg.v_global_pad, bool)
        vmask_new[perm] = True

    fn = _make_link_fn(pg, kind=kind, axis=AXIS, mesh=mesh,
                       comm_latency=comm_latency)
    with timer.time("process_ms"):
        hub, auth = jax.block_until_ready(fn(
            pg.csc_offsets, pg.csc_local, pg.row_offsets, pg.col_local,
            pg.ghost_send_idx, pg.fwd_ghost_send_idx,
            jnp.asarray(vmask_new).reshape(pg.num_shards, pg.shard_size),
            jnp.int32(max_iters)))

    hubs = np.asarray(hub).reshape(-1)[perm]
    auths = np.asarray(auth).reshape(-1)[perm]
    bytes_per_step = num_shards * (num_shards - 1) * \
        (pg.ghost_cap + pg.fwd_ghost_cap) * 4
    info = make_info(
        primitive=f"{kind}_sharded", graph=graph, timer=timer,
        edges_visited=2 * graph.num_edges * max_iters,
        extra={"num_shards": int(num_shards),
               "max_iteration": int(max_iters),
               "partition_method": partition_method,
               "ghost_cap": int(pg.ghost_cap),
               "fwd_ghost_cap": int(pg.fwd_ghost_cap),
               "comm_bytes_per_superstep": int(bytes_per_step),
               "comm_bytes": int(bytes_per_step) * int(max_iters),
               "comm_latency_rounds": comm_latency},
    )
    return ShardedLinkResult(hubs=hubs, auths=auths, info=info)


def hits_sharded(graph: CsrGraph, *, num_shards: int = None,
                 max_iters: int = 50, partition_method: str = "random",
                 seed: int = 0, mesh: Optional[Mesh] = None,
                 comm_latency: int = 0) -> ShardedLinkResult:
    """Sharded HITS; single-chip semantics (``models/hits.py``) with
    boundary-only exchanges per direction and pmax normalization."""
    return _link_sharded("hits", graph, num_shards=num_shards,
                         max_iters=max_iters,
                         partition_method=partition_method, seed=seed,
                         mesh=mesh, comm_latency=comm_latency)


def salsa_sharded(graph: CsrGraph, *, num_shards: int = None,
                  max_iters: int = 50, partition_method: str = "random",
                  seed: int = 0, mesh: Optional[Mesh] = None,
                  comm_latency: int = 0) -> ShardedLinkResult:
    """Sharded SALSA (row-stochastic dual sweeps, ``models/salsa.py``)."""
    return _link_sharded("salsa", graph, num_shards=num_shards,
                         max_iters=max_iters,
                         partition_method=partition_method, seed=seed,
                         mesh=mesh, comm_latency=comm_latency)
