"""Operator layer tests: advance / filter / segment primitives."""

import jax.numpy as jnp
import numpy as np

import gunrock_jax as gt
from gunrock_jax.ops import (compact, dedup_winners, expand,
                             frontier_from_mask, mask_from_frontier)


def _star_plus_chain():
    # 0 -> {1,2,3}, 1 -> {4}, 4 -> {}
    return gt.to_device(
        gt.from_coo(5, [0, 0, 0, 1], [1, 2, 3, 4]), with_csc=True)


def test_expand_basic():
    d = _star_plus_chain()
    frontier = jnp.zeros(8, jnp.int32).at[0].set(0).at[1].set(1)
    ex = expand(d, frontier, jnp.int32(2), out_cap=16)
    assert int(ex.total) == 4
    mask = np.asarray(ex.mask)
    assert mask[:4].all() and not mask[4:].any()
    assert np.asarray(ex.dst)[:4].tolist() == [1, 2, 3, 4]
    assert np.asarray(ex.src)[:4].tolist() == [0, 0, 0, 1]
    assert np.asarray(ex.rank)[:4].tolist() == [0, 0, 0, 1]


def test_expand_empty_and_zero_degree():
    d = _star_plus_chain()
    frontier = jnp.zeros(8, jnp.int32).at[0].set(4)  # degree 0 vertex
    ex = expand(d, frontier, jnp.int32(1), out_cap=16)
    assert int(ex.total) == 0
    ex2 = expand(d, frontier, jnp.int32(0), out_cap=16)
    assert int(ex2.total) == 0


def test_expand_overflow_reports_total():
    d = _star_plus_chain()
    frontier = jnp.zeros(8, jnp.int32)
    ex = expand(d, frontier, jnp.int32(1), out_cap=2)  # deg(0)=3 > 2
    assert int(ex.total) == 3
    assert int(np.asarray(ex.mask).sum()) == 2


def test_expand_inverse():
    d = _star_plus_chain()
    frontier = jnp.zeros(8, jnp.int32).at[0].set(4)
    ex = expand_inverse = gt.ops.expand_inverse(d, frontier, jnp.int32(1), 16)
    assert int(ex.total) == 1
    assert np.asarray(ex.dst)[0] == 1  # in-neighbor of 4 is 1


def test_dedup_winners_exact():
    idx = jnp.asarray([3, 5, 3, 3, 5, 7], jnp.int32)
    mask = jnp.asarray([1, 1, 1, 1, 1, 0], jnp.bool_)
    keep = np.asarray(dedup_winners(idx, mask, 8))
    assert keep.sum() == 2  # one winner each for 3 and 5; 7 masked out
    kept_vals = np.asarray(idx)[keep]
    assert sorted(kept_vals.tolist()) == [3, 5]


def test_compact():
    vals = jnp.asarray([10, 11, 12, 13], jnp.int32)
    mask = jnp.asarray([1, 0, 1, 1], jnp.bool_)
    out, cnt = compact(vals, mask, cap=8, fill=-1)
    assert int(cnt) == 3
    assert np.asarray(out)[:3].tolist() == [10, 12, 13]
    assert np.asarray(out)[3] == -1


def test_mask_frontier_roundtrip():
    mask = jnp.asarray([0, 1, 0, 1, 1, 0, 0, 0], jnp.bool_)
    frontier, n = frontier_from_mask(mask, cap=8)
    assert int(n) == 3
    back = mask_from_frontier(frontier, n, 8)
    assert np.array_equal(np.asarray(back), np.asarray(mask))


def test_pull_reduce_sum():
    d = _star_plus_chain()
    ones = jnp.ones((d.e_pad,), jnp.float32)
    # mask padded csc slots: only first num_edges are real
    vals = jnp.where(jnp.arange(d.e_pad) < d.num_edges, ones, 0.0)
    indeg = np.asarray(gt.ops.pull_reduce(d, vals, op="sum"))
    assert indeg[:5].tolist() == [0.0, 1.0, 1.0, 1.0, 1.0]


def test_row_reduce_sorted_sum_min_max():
    import jax.numpy as jnp
    from gunrock_jax.ops.segment import row_reduce_sorted
    # rows: [0,3) [3,3) [3,7) [7,8)  (row 1 empty)
    row = jnp.asarray([0, 3, 3, 7, 8], jnp.int32)
    vals = jnp.asarray([5, 2, 9, 1, 4, 4, 0, 7], jnp.float32)
    s = row_reduce_sorted(vals, row, op="sum")
    assert s.tolist() == [16.0, 0.0, 9.0, 7.0]
    m = row_reduce_sorted(vals, row, op="min")
    assert m.tolist()[0] == 2.0 and m.tolist()[2] == 0.0 and m.tolist()[3] == 7.0
    assert m.tolist()[1] == float("inf")
    M = row_reduce_sorted(vals, row, op="max")
    assert M.tolist() == [9.0, float("-inf"), 4.0, 7.0]


def test_row_reduce_sorted_matches_segment_ops(rmat_small):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import gunrock_jax as gt
    from gunrock_jax.ops.segment import row_reduce_sorted
    g = gt.to_device(rmat_small, with_csc=True)
    rng = np.random.default_rng(0)
    vals = jnp.asarray(rng.random(g.e_pad).astype(np.float32))
    ref_sum = jax.ops.segment_sum(vals, g.csc_edge_dst, g.v_pad,
                                  indices_are_sorted=True)
    got_sum = row_reduce_sorted(vals, g.csc_offsets, op="sum")
    # cumsum-boundary sums differ from per-segment sums by f32
    # accumulation order; tree-scan error is ~eps*log(E)*|total|.
    np.testing.assert_allclose(np.asarray(got_sum), np.asarray(ref_sum),
                               rtol=2e-2, atol=1e-3)
    ref_min = jax.ops.segment_min(vals, g.csc_edge_dst, g.v_pad,
                                  indices_are_sorted=True)
    got_min = row_reduce_sorted(vals, g.csc_offsets, op="min")
    deg = np.asarray(g.csc_offsets[1:]) - np.asarray(g.csc_offsets[:-1])
    nz = deg > 0
    np.testing.assert_allclose(np.asarray(got_min)[nz],
                               np.asarray(ref_min)[nz], rtol=1e-6)


def test_expand_zero_outdegree_frontier_vertex():
    """Directed frontier containing an out-degree-0 vertex must not
    desynchronize rank/src (regression: rank markers skipped zero-degree
    segments, so f[rank] pointed one slot early)."""
    import jax.numpy as jnp
    from gunrock_jax.ops.advance import expand
    g = gt.from_coo(8, np.array([0, 0, 2]), np.array([3, 4, 5]),
                    undirected=False)
    dg = gt.to_device(g)
    fr = jnp.asarray(np.array([0, 1, 2] + [7] * 5, dtype=np.int32))
    ex = expand(dg, fr, jnp.int32(3), 8, sorted_frontier=True)
    assert int(ex.total) == 3
    np.testing.assert_array_equal(np.asarray(ex.src)[:3], [0, 0, 2])
    np.testing.assert_array_equal(np.asarray(ex.dst)[:3], [3, 4, 5])
    np.testing.assert_array_equal(np.asarray(ex.eid)[:3], [0, 1, 2])


def test_expand_sorted_eid_monotone():
    """Sorted-mode expand must return a NONDECREASING eid stream across
    masked lanes (tail pinned to the last edge): consumers gather it with
    indices_are_sorted=True, which a zeroed tail would violate."""
    import jax.numpy as jnp
    from gunrock_jax.ops.advance import expand
    g = gt.io.rmat(scale=9, edge_factor=4, seed=3, undirected=True)
    dg = gt.to_device(g)
    fr = jnp.sort(jnp.array([3, 17, 200, 450] + [dg.v_pad - 1] * 60,
                            jnp.int32))
    for with_dst in (False, True):
        ex = expand(dg, fr, jnp.int32(4), 4096, sorted_frontier=True,
                    with_dst=with_dst)
        e = np.asarray(ex.eid).astype(np.int64)
        assert (np.diff(e) >= 0).all()
