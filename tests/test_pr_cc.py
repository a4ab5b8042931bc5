"""PageRank + CC vs CPU oracles (reference tests/pr, tests/cc)."""

import numpy as np
import pytest

import gunrock_jax as gt
from gunrock_jax.models.cc import cc
from gunrock_jax.models.pr import pagerank
from oracles import cpu_cc, cpu_pagerank


def test_pagerank_rmat(rmat_small):
    res = pagerank(rmat_small, max_iters=100, threshold=1e-9)
    expected = cpu_pagerank(rmat_small, max_iters=100, tol=1e-9)
    np.testing.assert_allclose(res.ranks, expected, rtol=1e-3)
    # mass matches the oracle (dangling vertices leak mass in both,
    # matching the reference's semantics)
    assert abs(res.ranks.sum() - expected.sum()) < 1e-3


def test_pagerank_compensated_mass(rmat_small):
    res = pagerank(rmat_small, compensate=True, max_iters=200,
                   threshold=1e-9)
    assert abs(res.ranks.sum() - 1.0) < 1e-3


def test_pagerank_sorted_output(rmat_small):
    res = pagerank(rmat_small)
    ranks_in_order = res.ranks[res.node_ids]
    assert (np.diff(ranks_in_order) <= 1e-12).all()


def test_pagerank_unnormalized(chesapeake):
    res = pagerank(chesapeake, normalized=False, max_iters=60,
                   threshold=1e-9)
    expected = cpu_pagerank(chesapeake, max_iters=60, tol=1e-12,
                            normalized=False)
    np.testing.assert_allclose(res.ranks, expected, rtol=1e-3)


def test_pagerank_convergence_early_stop(chesapeake):
    res = pagerank(chesapeake, threshold=1e-3, max_iters=1000)
    assert res.info["num_iterations"] < 1000


def test_cc_components(rmat_small):
    res = cc(rmat_small)
    expected = cpu_cc(rmat_small)
    np.testing.assert_array_equal(res.components, expected)
    assert res.num_components == len(np.unique(expected))


def test_cc_disconnected():
    # two triangles + isolated vertex
    src = np.array([0, 1, 2, 3, 4, 5])
    dst = np.array([1, 2, 0, 4, 5, 3])
    g = gt.from_coo(7, src, dst, undirected=True)
    res = cc(g)
    assert res.num_components == 3
    assert (res.components[:3] == 0).all()
    assert (res.components[3:6] == 3).all()
    assert res.components[6] == 6


def test_cc_log_rounds(road_like):
    """Hook+jump should converge in O(log V) outer rounds, not diameter."""
    res = cc(road_like)
    assert res.num_components == 1
    assert res.info["num_iterations"] <= 12


def test_cc_sum_balanced_asymmetric_graph():
    """_is_symmetric must not be fooled by sum-balanced asymmetric edge
    sets (a linear multiset hash collapses to comparing sum(src) with
    sum(dst)); directed input must be symmetrized so CC returns weak
    components (round-3 review finding)."""
    from gunrock_jax.models.cc import _is_symmetric
    n = 5002
    src = [0] * 4999 + list(range(1, 5000)) + [10, 5001]
    dst = list(range(1, 5000)) + [0] * 4999 + [5000, 11]
    g = gt.from_coo(n, src, dst, undirected=False, dedup=False)
    assert not _is_symmetric(g)
    res = cc(g)
    assert res.num_components == len(set(cpu_cc(g).tolist()))
