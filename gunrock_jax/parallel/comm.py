"""Boundary exchange: bucket-by-owner + all-to-all over the mesh.

This replaces the reference's entire multi-GPU communication backend
(``gunrock/app/enactor_helper.cuh`` PushNeighbor peer memcpys +
event handshakes, ``enactor_kernel.cuh:343`` Make_Output_Kernel bucketing,
``enactor_loop.cuh:267`` Expand_Incoming) with two steps expressed as XLA
collectives that ride NVLink (NCCL):

  1. ``bucket_by_owner`` — the Make_Output analogue: sort advance-output
     lanes by destination owner (owner = dst // shard_size, pure
     arithmetic thanks to the relabeling partitioner), scatter into a
     dense ``(p, B)`` per-peer send buffer + counts.
  2. ``jax.lax.all_to_all`` — the PushNeighbor analogue; XLA schedules it
     asynchronously, which subsumes the reference's per-peer stream/event
     stage machine.

The receive side (scatter-min/set merge into local state) lives with each
primitive, mirroring per-primitive Expand_Incoming.

Buffer sizing: ``B`` per peer is the ``--in-sizing`` analogue
(``problem_base.cuh:869-896`` preallocation); overflow is reported, not
silently dropped.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from ..utils.track import inject_latency

__all__ = ["bucket_by_owner", "exchange", "ghost_exchange"]


def ghost_exchange(axis_name: str, values_local: jax.Array,
                   send_idx: jax.Array, *, comm_latency: int = 0):
    """Boundary-only value exchange: local ``(S,)`` values -> compact local
    value table ``(S + p*ghost_cap,)`` addressed by ``csc_local``.

    ``send_idx`` is this shard's ``(p, ghost_cap)`` producer table (row i =
    local ids of my vertices that shard i reads). The all-to-all ships only
    boundary values — the reference's PushNeighbor associate payloads
    (``enactor_helper.cuh:297-405``), O(boundary) per superstep instead of
    the O(V) all-gather. Receives land in fixed slots by construction
    (consumer slot = position in the sorted ghost set G_ij), so the merge
    is a concatenate, not a scatter.
    """
    send = values_local[send_idx]                      # (p, G)
    recv = jax.lax.all_to_all(send, axis_name, split_axis=0,
                              concat_axis=0, tiled=True)
    recv = inject_latency(recv, comm_latency)
    return jnp.concatenate([values_local, recv.reshape(-1)])


def bucket_by_owner(owner: jax.Array, mask: jax.Array,
                    payloads: Sequence[jax.Array], *, num_shards: int,
                    per_peer_cap: int):
    """Pack masked lanes into dense per-peer buffers.

    Returns ``(bufs, counts, overflow)`` where each ``bufs[k]`` has shape
    ``(num_shards, per_peer_cap)``, ``counts`` is ``(num_shards,)``, and
    lanes beyond a peer's cap are dropped with ``overflow=True``.
    """
    cap = owner.shape[0]
    p = num_shards
    key = jnp.where(mask, owner, p)
    order = jnp.argsort(key, stable=True)
    skey = key[order]
    starts = jnp.searchsorted(skey, jnp.arange(p + 1, dtype=key.dtype),
                              side="left").astype(jnp.int32)
    counts = starts[1:] - starts[:-1]
    lane = jnp.arange(cap, dtype=jnp.int32)
    pos = lane - starts[jnp.minimum(skey, p - 1)]
    valid = (skey < p) & (pos < per_peer_cap)
    flat = jnp.where(valid, skey.astype(jnp.int32) * per_peer_cap + pos,
                     p * per_peer_cap)
    bufs = []
    for payload in payloads:
        sp = payload[order]
        buf = jnp.zeros((p * per_peer_cap,), payload.dtype).at[flat].set(
            sp, mode="drop").reshape(p, per_peer_cap)
        bufs.append(buf)
    overflow = jnp.any(counts > per_peer_cap)
    return bufs, jnp.minimum(counts, per_peer_cap), overflow


def exchange(axis_name: str, bufs: Sequence[jax.Array],
             counts: jax.Array):
    """All-to-all the per-peer buffers + counts.

    ``bufs[k]``: (p, B) where row j is destined for shard j. Returns
    ``(recv_bufs, recv_counts)`` with row j = what shard j sent here.
    """
    recv = [jax.lax.all_to_all(b, axis_name, split_axis=0, concat_axis=0,
                               tiled=True) for b in bufs]
    recv_counts = jax.lax.all_to_all(counts, axis_name, split_axis=0,
                                     concat_axis=0, tiled=True)
    return recv, recv_counts


def recv_mask(recv_counts: jax.Array, per_peer_cap: int) -> jax.Array:
    """(p, B) validity mask for received buffers."""
    lane = jnp.arange(per_peer_cap, dtype=jnp.int32)
    return lane[None, :] < recv_counts[:, None]
