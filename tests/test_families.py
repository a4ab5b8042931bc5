"""Primitive x graph-family parity through the public ``gt.*`` entry
points, on one uploaded DeviceGraph per family, checked with the same
checkers ``chip_smoke.py`` applies on the GPU: a Kronecker graph (scale
free), a uniform random graph (flat degrees, where direction
optimization helps less) and a grid (high diameter)."""

import numpy as np
import pytest

import chip_smoke as cs
import gunrock_jax as gt
from gunrock_jax.utils import reference as ref


def _urand(n=1500, m=9000, seed=33):
    rng = np.random.default_rng(seed)
    g = gt.from_coo(n, rng.integers(0, n, m), rng.integers(0, n, m),
                    undirected=True)
    g.random_edge_values(seed=seed)
    return g


FAMILIES = {
    "kron": lambda: cs.kron_graph(9, seed=2),
    "urand": _urand,
    "grid": lambda: cs.grid_graph(20, seed=3),
}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    g = FAMILIES[request.param]()
    dg = gt.to_device(g, with_csc=True, with_edge_values=True,
                      with_edge_src=True)
    return g, dg, cs.graph500_roots(g, 1, seed=5)[0]


@pytest.mark.parametrize("prim", ["bfs", "bfs_do", "sssp_bellman",
                                  "sssp_nearfar", "pagerank", "cc", "bc"])
def test_primitive_on_family(family, prim):
    g, dg, root = family
    if prim in ("bfs", "bfs_do"):
        res = gt.bfs(dg, root, mark_preds=True,
                     direction_optimized=prim == "bfs_do")
        cs.check_bfs(g, root, res.labels, res.preds)
    elif prim.startswith("sssp"):
        res = gt.sssp(dg, root, mode=prim.split("_")[1])
        cs.check_sssp(g, root, res.distances)
    elif prim == "pagerank":
        res = gt.pagerank(dg, threshold=0.0, max_iters=cs.PR_ITERS)
        cs.check_pr(g, res.ranks, cs.PR_ITERS)
    elif prim == "cc":
        cs.check_cc(g, gt.cc(dg).components)
    else:
        res = gt.bc(dg, root)
        cs.check_rel("bc", res.bc_values, ref.cpu_bc(g, root))
