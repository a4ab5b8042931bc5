"""Vectorised CPU oracles (``utils/reference.py``) against the plain
per-edge loop oracles, on graph families with the shapes the fast ones
must handle: directed, symmetric, high-diameter, isolated vertices and
duplicate edges."""

import numpy as np
import pytest

import gunrock_jax as gt
from gunrock_jax.utils import reference as ref


def _grid(side):
    idx = np.arange(side * side).reshape(side, side)
    src = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    dst = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    return gt.from_coo(side * side, src, dst, undirected=True)


def _multi():
    """Duplicate edges with different weights, isolated vertices."""
    rng = np.random.default_rng(5)
    src = rng.integers(0, 150, 900)
    dst = rng.integers(0, 150, 900)
    g = gt.from_coo(200, src, dst, rng.uniform(0, 9, 900), dedup=False)
    return g


GRAPHS = {
    "kron_sym": lambda: gt.io.rmat(scale=8, edge_factor=8, seed=3,
                                   undirected=True),
    "kron_dir": lambda: gt.io.rmat(scale=8, edge_factor=6, seed=4,
                                   undirected=False),
    "grid": lambda: _grid(14),
    "multi": _multi,
}


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def graph(request):
    g = GRAPHS[request.param]()
    if g.edge_values is None:
        g.random_edge_values(seed=11)
    return g


def _loop_pagerank(g, damping=0.85, iters=15):
    n = g.num_nodes
    rank = [1.0 / n] * n
    row, col = g.row_offsets, g.col_indices
    for _ in range(iters):
        nxt = [(1.0 - damping) / n] * n
        for u in range(n):
            deg = row[u + 1] - row[u]
            for e in range(row[u], row[u + 1]):
                nxt[col[e]] += damping * rank[u] / deg
        rank = nxt
    return np.asarray(rank)


def _sources(g):
    deg = np.diff(g.row_offsets)
    return [int(np.argmax(deg)), int(np.flatnonzero(deg > 0)[-1])]


@pytest.mark.parametrize("oracle", ["bfs", "sssp", "cc", "pagerank"])
def test_vectorised_oracle_matches_loop(graph, oracle):
    if oracle == "bfs":
        for s in _sources(graph):
            np.testing.assert_array_equal(ref.bfs_levels(graph, s),
                                          ref.cpu_bfs(graph, s))
    elif oracle == "sssp":
        for s in _sources(graph):
            np.testing.assert_allclose(ref.sssp_dijkstra(graph, s),
                                       ref.cpu_sssp(graph, s), rtol=1e-12)
    elif oracle == "cc":
        np.testing.assert_array_equal(ref.cc_min_label(graph),
                                      ref.cpu_cc(graph))
    else:
        np.testing.assert_allclose(
            ref.cpu_pagerank(graph, max_iters=15, tol=0.0),
            _loop_pagerank(graph), rtol=1e-12, atol=1e-15)
