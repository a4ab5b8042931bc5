"""Triangle counting (segmented intersection operator)."""

import numpy as np

import gunrock_jax as gt
from gunrock_jax.models.tc import tc

from oracles import cpu_bfs  # noqa: F401  (env setup via conftest)
from gunrock_jax.utils.reference import cpu_tc


def test_tc_triangle():
    # Single triangle plus a pendant vertex.
    src = np.array([0, 1, 2, 2])
    dst = np.array([1, 2, 0, 3])
    g = gt.from_coo(4, src, dst, undirected=True)
    res = tc(g)
    assert res.total == 1
    assert res.vertex_counts.tolist() == [1, 1, 1, 0]


def test_tc_k4():
    # Complete graph K4 has 4 triangles, each vertex in 3.
    src, dst = zip(*[(i, j) for i in range(4) for j in range(4) if i < j])
    g = gt.from_coo(4, np.array(src), np.array(dst), undirected=True)
    res = tc(g)
    assert res.total == 4
    assert res.vertex_counts.tolist() == [3, 3, 3, 3]


def test_tc_triangle_free():
    # Bipartite (grid) graphs have no triangles.
    n = 8
    idx = np.arange(n * n).reshape(n, n)
    src = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    dst = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    g = gt.from_coo(n * n, src, dst, undirected=True)
    assert tc(g).total == 0


def test_tc_matches_oracle(rmat_small):
    res = tc(rmat_small)
    assert res.total == cpu_tc(rmat_small)
    # 3 corners per triangle.
    assert int(res.vertex_counts.sum()) == 3 * res.total


def test_tc_chesapeake(chesapeake):
    res = tc(chesapeake)
    assert res.total == cpu_tc(chesapeake)
    assert res.info["num_triangles"] == res.total
