"""Simplified array API (gunrock.h parity) + converter tools."""

import os
import sys

import numpy as np

import conftest  # noqa: F401
import gunrock_jax as gt
from gunrock_jax import api
from oracles import cpu_bfs, cpu_sssp, cpu_cc

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import convert  # noqa: E402


def _csr(g):
    return g.num_nodes, g.row_offsets, g.col_indices


def test_api_bfs(rmat_small):
    labels = api.bfs(*_csr(rmat_small), src=0)
    np.testing.assert_array_equal(labels, cpu_bfs(rmat_small, 0))


def test_api_bfs_preds(rmat_small):
    labels, preds = api.bfs(*_csr(rmat_small), src=0, mark_preds=True)
    ok = labels > 0
    # every pred is one level up
    np.testing.assert_array_equal(labels[preds[ok]], labels[ok] - 1)


def test_api_sssp(rmat_small):
    rmat_small.random_edge_values(seed=2)
    d = api.sssp(*_csr(rmat_small), rmat_small.edge_values, src=0)
    ref = cpu_sssp(rmat_small, 0)
    got = np.where(np.isfinite(d), d, np.inf)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_api_cc_pagerank_topk_tc(chesapeake):
    comp, n = api.cc(*_csr(chesapeake))
    assert n == len(np.unique(cpu_cc(chesapeake)))
    ids, ranks = api.pagerank(*_csr(chesapeake), max_iters=30)
    assert (np.diff(ranks) <= 1e-9).all()  # sorted descending
    nids, cent = api.topk(*_csr(chesapeake), k=5)
    assert len(nids) == 5
    assert api.tc(*_csr(chesapeake)) > 0


def test_convert_roundtrip(tmp_path, chesapeake):
    b = str(tmp_path / "g.csr.npz")
    m = str(tmp_path / "g.mtx")
    chesapeake.write_binary(b)
    assert convert.main(["bin2mtx", b, m]) == 0
    assert convert.main(["mtx2bin", m, b + "2", "--undirected"]) == 0
    g2 = gt.CsrGraph.read_binary(b + "2")
    assert g2.num_nodes == chesapeake.num_nodes
    assert g2.num_edges == chesapeake.num_edges


def test_convert_weights(tmp_path, rmat_small):
    b = str(tmp_path / "g.csr.npz")
    rmat_small.write_binary(b)
    w = str(tmp_path / "w.csr.npz")
    assert convert.main(["add-weights", b, w, "--seed", "3"]) == 0
    gw = gt.CsrGraph.read_binary(w)
    assert gw.edge_values is not None and gw.edge_values.shape[0] == gw.num_edges
    s = str(tmp_path / "s.csr.npz")
    assert convert.main(["strip-weights", w, s]) == 0
    assert gt.CsrGraph.read_binary(s).edge_values is None


def test_convert_info(capsys, chesapeake, tmp_path):
    b = str(tmp_path / "g.csr.npz")
    chesapeake.write_binary(b)
    assert convert.main(["info", b]) == 0
    out = capsys.readouterr().out
    assert "|V|=39" in out and "histogram" in out


def test_info_has_gitsha(rmat_small):
    r = gt.bfs(rmat_small, 0)
    assert len(r.info["git_commit_sha1"]) >= 7


def test_modularity(chesapeake):
    from gunrock_jax.utils.modularity import modularity
    comp = gt.cc(chesapeake).components
    q1 = modularity(chesapeake, comp)          # one community: Q ~ 0
    assert abs(q1) < 1e-6
    # a random 2-split should have Q <= 0-ish; a degree-sorted split too
    rng = np.random.default_rng(0)
    rand = rng.integers(0, 2, chesapeake.num_nodes)
    assert modularity(chesapeake, rand) < 0.05
