"""Advance operator: frontier neighbor expansion as static-shape XLA.

The reference's advance is a zoo of CUDA load-balancing kernels
(``oprtr/advance/kernel.cuh`` dispatching TWC/LB/LB_CULL variants; the LB
path does degree-count + ModernGPU scan in ``ComputeOutputLength``
(``kernel.cuh:76-182``) then per-thread binary search over scanned offsets
in ``RelaxPartitionedEdges2`` (``oprtr/edge_map_partitioned/kernel.cuh:185``)).

This formulation collapses all of that into one static-shape dataflow:

    degrees = row_offsets[f+1] - row_offsets[f]        (gather)
    ends    = cumsum(degrees)                          (scan)
    rank    = searchsorted(ends, iota(out_cap))        (vectorized merge-path)
    eid     = row_offsets[f[rank]] + (i - start(rank))
    dst     = col_indices[eid]                         (gather)

Every output lane independently binary-searches which frontier segment it
falls in — the exact same work assignment as the reference's merge-path LB
kernels, but expressed as dense vector ops. There is no TWC-vs-LB distinction to make: lanes are
load-balanced by construction.

Push (CSR) and pull (CSC, full-edge) variants are both provided; direction
optimization picks between them per iteration (``app/bfs/bfs_enactor.cuh:852``).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..graph.device import DeviceGraph

__all__ = ["ExpandedEdges", "expand", "expand_inverse", "pull_reduce"]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["src", "dst", "eid", "rank", "mask", "total"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class ExpandedEdges:
    """One (src -> dst) record per output lane of an advance.

    ``rank`` is the frontier slot that produced the lane (the reference's
    ``input_pos`` in the functor contract, ``oprtr/advance_base.cuh:37``);
    ``total`` is the true number of active lanes (``output_length`` in
    ``ComputeOutputLength``) — lanes >= total have ``mask=False``.
    ``total`` may exceed the static capacity: callers surface that as an
    overflow diagnostic (reference ``Check_Size``, ``enactor_helper.cuh:103``).
    """

    src: jax.Array     # (out_cap,) int32
    dst: jax.Array     # (out_cap,) int32
    eid: jax.Array     # (out_cap,) int32   edge id into col_indices
    rank: jax.Array    # (out_cap,) int32   frontier slot
    mask: jax.Array    # (out_cap,) bool
    total: jax.Array   # ()        int32


def _expand_markers(row_offsets: jax.Array, frontier: jax.Array,
                    n: jax.Array, ncap: int, out_cap: int,
                    sorted_frontier: bool):
    """Rank/eid marker construction over the first ``ncap`` frontier
    lanes: all scatters here have ``ncap`` lanes, so laddering ``ncap``
    by the frontier LENGTH (not the output capacity) keeps the
    frontier-side cost proportional to the frontier — the two
    out_cap-lane marker scatters were ~12 ns/output-lane of pure
    overhead when the frontier was three orders smaller than the rung."""
    cin = frontier.shape[0]
    fr = jax.lax.dynamic_slice(frontier, (0,), (ncap,)) \
        if ncap < cin else frontier
    lane_in = jnp.arange(ncap, dtype=jnp.int32)
    valid = lane_in < n
    # Inactive lanes pin to the LAST vertex in sorted mode so the gather
    # stream stays monotonic (callers guarantee active lanes ascending).
    fill_v = row_offsets.shape[0] - 2 if sorted_frontier else 0
    f = jnp.where(valid, fr, fill_v)
    start = jnp.take(row_offsets, f, indices_are_sorted=sorted_frontier)
    deg = jnp.where(
        valid,
        jnp.take(row_offsets, f + 1,
                 indices_are_sorted=sorted_frontier) - start, 0)
    ends = jnp.cumsum(deg)                     # inclusive scan
    # total is a stat/overflow probe: int32 (clipped) regardless of the
    # offsets dtype so loop-state dtypes stay stable under --64bit-SizeT.
    total = jnp.minimum(ends[-1], 2**31 - 1).astype(jnp.int32) \
        if ncap > 0 else jnp.int32(0)

    # Which frontier segment does output lane j land in? Instead of a
    # per-lane binary search over the scanned degrees (the reference's
    # merge-path, edge_map_partitioned/kernel.cuh:309-331 — log(V) random
    # gathers per lane), scatter a +1 marker
    # at every segment start and take a running sum: rank[j] = number of
    # segment starts at or before j, minus one. Zero-degree segments
    # collapse onto the next start (multiple +1s at one position) so
    # rank still equals the FRONTIER slot index — filtering them out
    # would desynchronize f[rank] whenever a directed frontier contains
    # an out-degree-0 vertex.
    seg_starts = ends - deg                    # start position per segment
    pos = jnp.where(valid, seg_starts, out_cap)
    markers = jnp.zeros((out_cap,), jnp.int32).at[pos].add(1, mode="drop")
    # eid[j] = start[rank] + (j - seg_start[rank]) = j + offset[rank]
    # with offset = start - seg_start constant per segment. Scattering
    # the TELESCOPING offset deltas at segment starts and cumsumming
    # replaces three rank-indexed cap-scale gathers with one cap-scale
    # scan; collapsed zero-degree segments' deltas sum correctly at the
    # shared position.
    offset = start - seg_starts
    off_prev = jnp.concatenate(
        [offset[:1], offset[1:] - offset[:-1]])
    odeltas = jnp.zeros((out_cap,), offset.dtype).at[pos].add(
        off_prev, mode="drop")
    # Source ids by the same telescoping-delta trick (exact for ints):
    # src[j] = f[rank[j]] = running sum of per-segment f deltas — one
    # more ncap-lane scatter + a cap-scale cumsum replaces a cap-scale
    # rank-indexed gather.
    f_prev = jnp.concatenate([f[:1], f[1:] - f[:-1]])
    sdeltas = jnp.zeros((out_cap,), jnp.int32).at[pos].add(
        f_prev.astype(jnp.int32), mode="drop")
    return markers, odeltas, sdeltas, total


def _expand_csr(row_offsets: jax.Array, col_indices: jax.Array,
                frontier: jax.Array, n: jax.Array,
                out_cap: int, sorted_frontier: bool = False,
                with_src: bool = True,
                with_dst: bool = True) -> ExpandedEdges:
    cin = frontier.shape[0]
    # Frontier-side ladder: scatters run at the smallest rung >= n.
    from ..enactor import frontier_ladder
    ncaps = frontier_ladder(cin)

    if len(ncaps) == 1:
        markers, odeltas, sdeltas, total = _expand_markers(
            row_offsets, frontier, n, cin, out_cap, sorted_frontier)
    else:
        from ..enactor import dispatch_by_size

        def mk(ncap):
            def f(_):
                return _expand_markers(row_offsets, frontier, n, ncap,
                                       out_cap, sorted_frontier)
            return f

        markers, odeltas, sdeltas, total = dispatch_by_size(
            jnp.maximum(n, 1), ncaps, mk, None)

    rank = jnp.cumsum(markers) - 1             # (out_cap,)
    rank_c = jnp.clip(rank, 0, cin - 1)
    j = jnp.arange(out_cap, dtype=jnp.int32)
    eid = j + jnp.cumsum(odeltas)
    mask = (j < total) & (rank >= 0)
    # In sorted mode the returned eid stream must stay NONDECREASING
    # across masked lanes: consumers gather with indices_are_sorted=True,
    # which a zeroed tail would violate. Pin masked lanes to the LAST
    # edge instead (consumers predicate on ``mask``).
    tail = jnp.int32(col_indices.shape[0] - 1 if sorted_frontier else 0)
    if not with_dst:
        eid_c = jnp.where(mask, eid, tail)
        dst = jnp.zeros_like(eid_c)
    elif sorted_frontier:
        eid_c = jnp.where(mask, eid, tail)
        dst = jnp.where(mask,
                        jnp.take(col_indices, eid_c,
                                 indices_are_sorted=True), 0)
    else:
        eid_c = jnp.where(mask, eid, 0)
        dst = jnp.where(mask, col_indices[eid_c], 0)
    if with_src:
        # Masked lanes keep the running value (NOT zeroed): the stream
        # stays nondecreasing in sorted mode, which sorted gathers
        # require; callers predicate on ``mask`` anyway.
        src = jnp.cumsum(sdeltas)
    else:
        src = jnp.zeros((out_cap,), jnp.int32)
    return ExpandedEdges(src=src, dst=dst, eid=eid_c, rank=rank_c,
                         mask=mask, total=total)


def expand(graph: DeviceGraph, frontier: jax.Array, n: jax.Array,
           out_cap: int, sorted_frontier: bool = False,
           with_src: bool = True, with_dst: bool = True) -> ExpandedEdges:
    """Push-mode advance (V2V/V2E over the forward CSR). Pass
    ``sorted_frontier=True`` (active lanes ascending) to enable
    monotonic-gather fast paths. ``with_src/with_dst=False`` skip the
    cap-scale payload gathers (callers that gather payloads by eid
    themselves need only eid/rank)."""
    return _expand_csr(graph.row_offsets, graph.col_indices, frontier, n,
                       out_cap, sorted_frontier, with_src=with_src,
                       with_dst=with_dst)


def expand_inverse(graph: DeviceGraph, frontier: jax.Array, n: jax.Array,
                   out_cap: int) -> ExpandedEdges:
    """Advance over the inverse CSR: expands *in*-neighbors of the frontier
    (reference TWC/LB backward over ``column_offsets/row_indices``,
    ``oprtr/edge_map_backward/``). ``dst`` lanes are in-neighbor sources."""
    assert graph.has_csc, "graph was loaded without with_csc=True"
    return _expand_csr(graph.csc_offsets, graph.csc_indices, frontier, n, out_cap)


def pull_reduce(graph: DeviceGraph, edge_vals: jax.Array, *,
                op: str = "sum") -> jax.Array:
    """Full-edge pull: reduce per-in-edge values into each destination.

    ``edge_vals`` is indexed by CSC edge slot (same order as
    ``graph.csc_indices``); returns a (v_pad,) per-vertex reduction.
    This is the replacement for pull-mode advance + SegReduceCsr —
    segment ids (``csc_edge_dst``) are sorted, so XLA lowers this to a
    contiguous segmented reduction.
    """
    assert graph.has_csc
    num_segments = graph.v_pad
    seg = graph.csc_edge_dst
    if op == "sum":
        return jax.ops.segment_sum(edge_vals, seg, num_segments,
                                   indices_are_sorted=True)
    if op == "max":
        return jax.ops.segment_max(edge_vals, seg, num_segments,
                                   indices_are_sorted=True)
    if op == "min":
        return jax.ops.segment_min(edge_vals, seg, num_segments,
                                   indices_are_sorted=True)
    raise ValueError(f"unknown op {op!r}")
