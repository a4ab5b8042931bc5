"""Scatter/segment reductions — the primitives' "atomics".

The reference implements per-edge updates with CUDA atomics
(``atomicMin`` in BFS/SSSP functors ``app/bfs/bfs_functor.cuh:71-74``,
``atomicAdd`` for BC sigmas ``app/bc/bc_functor.cuh:70-71``) and fused
segmented reductions via ModernGPU SegReduceCsr
(``oprtr/advance/kernel.cuh:318-349``). Here they are XLA scatter ops
(``Array.at[].min/max/add``) and ``jax.ops.segment_*``. Integer and
min/max results are exact; float sums may run in a different order from
run to run where the backend lowers scatter-add to atomics.

Masking convention: callers pass indices already redirected to an
out-of-bounds slot (``size``) for inactive lanes and use ``mode='drop'`` —
XLA drops out-of-bounds scatters, giving us free predication.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "scatter_min", "scatter_max", "scatter_add", "scatter_set",
    "masked_idx", "dedup_winners", "compact", "frontier_from_mask",
    "mask_from_frontier", "row_reduce_sorted",
]


def masked_idx(idx: jax.Array, mask: jax.Array, size: int) -> jax.Array:
    """Redirect inactive lanes to the out-of-bounds slot ``size`` so a
    ``mode='drop'`` scatter ignores them."""
    return jnp.where(mask, idx, size)


def scatter_min(dest: jax.Array, idx: jax.Array, vals: jax.Array,
                mask: jax.Array | None = None) -> jax.Array:
    if mask is not None:
        idx = masked_idx(idx, mask, dest.shape[0])
    return dest.at[idx].min(vals, mode="drop")


def scatter_max(dest: jax.Array, idx: jax.Array, vals: jax.Array,
                mask: jax.Array | None = None) -> jax.Array:
    if mask is not None:
        idx = masked_idx(idx, mask, dest.shape[0])
    return dest.at[idx].max(vals, mode="drop")


def scatter_add(dest: jax.Array, idx: jax.Array, vals: jax.Array,
                mask: jax.Array | None = None) -> jax.Array:
    if mask is not None:
        idx = masked_idx(idx, mask, dest.shape[0])
    return dest.at[idx].add(vals, mode="drop")


def scatter_set(dest: jax.Array, idx: jax.Array, vals: jax.Array,
                mask: jax.Array | None = None) -> jax.Array:
    """Unlike atomic races in the reference, duplicate indices here resolve
    in scatter order (last wins under XLA's semantics) — prefer running
    :func:`dedup_winners` first when the winner matters."""
    if mask is not None:
        idx = masked_idx(idx, mask, dest.shape[0])
    return dest.at[idx].set(vals, mode="drop")


def dedup_winners(idx: jax.Array, mask: jax.Array, size: int) -> jax.Array:
    """Pick one winner lane per distinct index; returns the winner mask.

    Replaces the reference's CULL-filter hash/bitmask duplicate culling
    (``oprtr/cull_filter/cta.cuh:351-379``) with a deterministic
    "claim" scatter: every active lane writes its lane id into a claim
    table with max-reduce; a lane survives iff it reads its own id back.
    """
    lane = jnp.arange(idx.shape[0], dtype=jnp.int32)
    claims = jnp.zeros((size,), jnp.int32).at[
        masked_idx(idx, mask, size)
    ].max(lane + 1, mode="drop")
    safe = jnp.where(mask, idx, 0)
    return mask & (claims[safe] == lane + 1)


def compact(vals: jax.Array, mask: jax.Array, cap: int,
            fill: int = 0) -> tuple[jax.Array, jax.Array]:
    """Stream-compact ``vals[mask]`` into a ``cap``-sized buffer.

    The replacement for CUB DeviceSelect (``util/select_utils.cuh:47``)
    and the raking-scan compaction in the CULL filter: exclusive-scan the
    mask for output slots, scatter. Returns (buffer, count); lanes past
    ``count`` hold ``fill``. Overflow (count > cap) drops the tail —
    callers track it via the returned count (reference ``Check_Size``
    regrow becomes "re-run with larger sizing").
    """
    pos = jnp.cumsum(mask.astype(jnp.int32)) - 1
    count = jnp.where(mask.shape[0] > 0, pos[-1] + 1, 0)
    out = jnp.full((cap,), fill, dtype=vals.dtype)
    out = out.at[masked_idx(pos, mask & (pos < cap), cap)].set(vals, mode="drop")
    return out, count


def row_reduce_sorted(vals: jax.Array, row_offsets: jax.Array, *,
                      op: str, identity=None) -> jax.Array:
    """Per-row reduction over CSR-ordered edge values.

      * ``sum``: ``segment_sum`` over per-edge row ids (an exact integer
        scan of the row-start marks). A float running sum differenced at
        row boundaries would cancel catastrophically once the running
        total dwarfs a row's own sum (PageRank over ~10^8 edges).
      * ``min``/``max``: segmented scan (value, reset-flag pairs) via
        ``associative_scan`` — log(E) elementwise passes — then the value
        at ``end - 1``

    ``row_offsets`` has V+1 entries over ``vals``'s edge order (edges of
    row v at ``[row_offsets[v], row_offsets[v+1])``; rows may be empty;
    slots past ``row_offsets[-1]`` are padding and ignored).
    Empty rows get ``identity`` (defaults: 0 / +inf / -inf).
    Equivalent role to ModernGPU SegReduceCsr in the reference
    (``oprtr/advance/kernel.cuh:318-349``).
    """
    e_pad = vals.shape[0]
    starts = row_offsets[:-1]
    ends = row_offsets[1:]
    if op == "sum":
        nrows = starts.shape[0]
        marks = jnp.zeros((e_pad,), jnp.int32).at[starts].add(
            1, mode="drop")
        row = jnp.cumsum(marks) - 1
        row = jnp.where(jnp.arange(e_pad) < row_offsets[-1], row, nrows)
        return jax.ops.segment_sum(vals, row, num_segments=nrows,
                                   indices_are_sorted=True)

    if op not in ("min", "max"):
        raise ValueError(f"unknown op {op!r}")
    if identity is None:
        if jnp.issubdtype(vals.dtype, jnp.floating):
            identity = jnp.inf if op == "min" else -jnp.inf
        else:
            info = jnp.iinfo(vals.dtype)
            identity = info.max if op == "min" else info.min
    identity = jnp.asarray(identity, vals.dtype)

    # Row-start flags, computed by scatter at vertex scale (cheap).
    flags = jnp.zeros((e_pad,), jnp.bool_).at[
        jnp.minimum(starts, e_pad)
    ].set(True, mode="drop")

    combine = jnp.minimum if op == "min" else jnp.maximum

    def scan_op(a, b):
        va, fa = a
        vb, fb = b
        return jnp.where(fb, vb, combine(va, vb)), fa | fb

    seg_vals, _ = jax.lax.associative_scan(scan_op, (vals, flags))
    out = jnp.take(seg_vals, jnp.maximum(ends - 1, 0),
                   indices_are_sorted=True)
    return jnp.where(ends > starts, out, identity)


def frontier_from_mask(mask: jax.Array, cap: int) -> tuple[jax.Array, jax.Array]:
    """Dense vertex mask -> compacted frontier index vector + length."""
    verts = jnp.arange(mask.shape[0], dtype=jnp.int32)
    return compact(verts, mask, cap)


def mask_from_frontier(frontier: jax.Array, n: jax.Array, size: int) -> jax.Array:
    """Compacted frontier -> dense boolean mask (for pull-mode advance)."""
    lane = jnp.arange(frontier.shape[0], dtype=jnp.int32)
    active = lane < n
    return jnp.zeros((size,), jnp.bool_).at[
        masked_idx(frontier, active, size)
    ].set(True, mode="drop")
