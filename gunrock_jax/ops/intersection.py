"""Segmented intersection operator — the reference's documented 4th
operator (``doc/programming_model.md`` "Operators": advance / filter /
compute / *segmented intersection*, used for triangle counting; the CUDA
implementation is absent from the reference snapshot, only the doc and
``util/join.cuh`` leftovers exist).

Formulation: wedge membership probes are a SORT-JOIN, not per-lane
binary searches —

    wedges  = advance over the second endpoint's adjacency
              (marker-scatter + cumsum rank assignment, advance.py style)
    join    = lax.sort of [edges ++ wedges] by (u, w, tag): a wedge
              (u, v, w) is a triangle iff an edge (u, w) lands earlier
              in its (u, w) run — one segmented-OR scan resolves every
              probe in a handful of vector passes
    count   = scatter-add of hits per originating edge / corner

Everything is dense vector work (sorts, scans, lane-scale scatters); no
per-wedge serial probing remains.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["row_probe", "intersect_counts"]


def row_probe(row_offsets: jax.Array, col_indices: jax.Array,
              u: jax.Array, w: jax.Array, steps: int) -> jax.Array:
    """Lane-parallel membership test: is ``w`` in the sorted CSR row of
    ``u``? ``steps`` must be >= ceil(log2(max_degree + 1)) (static).
    Kept for small/one-off probes; the TC path uses the sort-join."""
    e_pad = col_indices.shape[0]
    lo = row_offsets[u]
    hi = row_offsets[u + 1]
    end = hi

    def body(_, carry):
        lo, hi = carry
        mid = (lo + hi) // 2
        val = col_indices[jnp.minimum(mid, e_pad - 1)]
        go_right = val < w
        return (jnp.where(go_right, mid + 1, lo),
                jnp.where(go_right, hi, mid))

    lo, hi = jax.lax.fori_loop(0, steps, body, (lo, hi))
    return (lo < end) & (col_indices[jnp.minimum(lo, e_pad - 1)] == w)


def intersect_counts(row_offsets: jax.Array, col_indices: jax.Array,
                     edge_src: jax.Array, chunk_src: jax.Array,
                     chunk_dst: jax.Array, num_edges: int, wedge_cap: int,
                     ) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Per-edge |N(u) ∩ N(v)| for the edge chunk (chunk_src, chunk_dst)
    over one CSR (typically degree-oriented).

    ``edge_src`` is the global per-edge source array (COO rows, padded
    with ``v_pad`` so pad lanes never join). For each chunk edge
    e=(u, v), expands the wedge set {(u, v, w): w ∈ N(v)} and resolves
    every "is (u, w) an edge?" probe with one global sort-join. Edge
    chunking bounds the wedge working set — callers size ``wedge_cap``
    from the chunk's exact wedge count and loop over chunks for big
    graphs. Returns ``(per_chunk_edge_counts, per_vertex_counts,
    total_wedges)``.
    """
    e_pad = chunk_src.shape[0]
    eg_pad = col_indices.shape[0]
    v_pad = row_offsets.shape[0] - 1
    lane_e = jnp.arange(e_pad, dtype=jnp.int32)
    evalid = lane_e < num_edges
    # Degree of each edge's *destination* = wedge fanout.
    v = jnp.where(evalid, chunk_dst, 0)
    start_v = row_offsets[v]
    deg = jnp.where(evalid, row_offsets[v + 1] - start_v, 0)
    ends = jnp.cumsum(deg)
    total = ends[-1] if e_pad else jnp.int32(0)

    # Rank/eid assignment via marker scatters + cumsums (advance.py
    # dataflow; zero-degree segments collapse onto the next start).
    seg_starts = ends - deg
    pos = jnp.where(evalid, seg_starts, wedge_cap)
    markers = jnp.zeros((wedge_cap,), jnp.int32).at[pos].add(1, mode="drop")
    rank = jnp.cumsum(markers) - 1
    rank_c = jnp.clip(rank, 0, e_pad - 1)
    offset = start_v - seg_starts
    off_prev = jnp.concatenate([offset[:1], offset[1:] - offset[:-1]])
    odeltas = jnp.zeros((wedge_cap,), offset.dtype).at[pos].add(
        off_prev, mode="drop")
    j = jnp.arange(wedge_cap, dtype=jnp.int32)
    wedge_eid = j + jnp.cumsum(odeltas)
    mask = (j < total) & (rank >= 0)
    wedge_eid = jnp.where(mask, wedge_eid, 0)

    # u via the telescoping-delta trick (exact ints, no rank gather).
    u_src = jnp.where(evalid, chunk_src, 0)
    u_prev = jnp.concatenate([u_src[:1], u_src[1:] - u_src[:-1]])
    udeltas = jnp.zeros((wedge_cap,), jnp.int32).at[pos].add(
        u_prev, mode="drop")
    u = jnp.cumsum(udeltas)

    w = col_indices[wedge_eid]                 # candidate third vertex
    u = jnp.where(mask, u, v_pad)
    w = jnp.where(mask, w, v_pad)

    # ---- sort-join: edges (tag 0) ++ wedges (tag 1) by (u, w, tag)
    # The pre-sorted edge stream is re-sorted with every chunk's wedges;
    # with the 2**26 wedge budget the edge share of the sort is <10% per
    # chunk, so a two-stream merge isn't worth its complexity until
    # many-chunk graphs dominate.
    ju = jnp.concatenate([edge_src.astype(jnp.int32), u])
    jw = jnp.concatenate([col_indices.astype(jnp.int32), w])
    jtag = jnp.concatenate([jnp.zeros((eg_pad,), jnp.int32),
                            jnp.ones((wedge_cap,), jnp.int32)])
    jrank = jnp.concatenate([jnp.full((eg_pad,), e_pad, jnp.int32),
                             jnp.where(mask, rank_c, e_pad)])
    su, sw, stag, srank = jax.lax.sort((ju, jw, jtag, jrank), num_keys=3)

    # Segmented OR of is_edge within (u, w) runs: edges sort first, so
    # any wedge in a run containing an edge reads hit=1 from the scan.
    run_start = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_),
         (su[1:] != su[:-1]) | (sw[1:] != sw[:-1])])
    is_edge = stag == 0

    def op(a, b):
        va, fa = a
        vb, fb = b
        return jnp.where(fb, vb, va | vb), fa | fb

    seen_edge, _ = jax.lax.associative_scan(op, (is_edge, run_start))
    hit = seen_edge & (stag == 1) & (su < v_pad)

    counts = jnp.zeros((e_pad,), jnp.int32).at[
        jnp.where(hit, srank, e_pad)].add(1, mode="drop")
    counts = jnp.where(evalid, counts, 0)

    # Credit each found triangle (u, v, w) to all three corners: w from
    # the sorted stream, u/v from per-edge counts (lane-scale only).
    vcounts = jnp.zeros((v_pad,), jnp.int32)
    vcounts = vcounts.at[jnp.where(hit, sw, v_pad)].add(1, mode="drop")
    vcounts = vcounts.at[jnp.where(evalid, chunk_src, v_pad)].add(
        counts, mode="drop")
    vcounts = vcounts.at[jnp.where(evalid, chunk_dst, v_pad)].add(
        counts, mode="drop")
    return counts, vcounts, total
