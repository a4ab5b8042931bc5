"""Graph container + I/O tests (reference L0/L1 layers)."""

import numpy as np
import pytest

import gunrock_jax as gt


def test_from_coo_dedup_selfloop():
    # 0->1 twice, 1->1 self loop, 2->0
    src = np.array([0, 0, 1, 2])
    dst = np.array([1, 1, 1, 0])
    g = gt.from_coo(3, src, dst)
    assert g.num_edges == 2
    assert g.row_offsets.tolist() == [0, 1, 1, 2]
    assert g.col_indices.tolist() == [1, 0]


def test_from_coo_symmetrize():
    g = gt.from_coo(3, [0], [1], undirected=True)
    assert g.num_edges == 2
    assert sorted(zip(g.edge_sources().tolist(), g.col_indices.tolist())) == \
        [(0, 1), (1, 0)]


def test_csc_roundtrip():
    g = gt.from_coo(4, [0, 0, 1, 3], [1, 2, 2, 0])
    t = g.csc()
    assert t.num_edges == g.num_edges
    tt = t.csc()
    assert np.array_equal(tt.row_offsets, g.row_offsets)
    assert np.array_equal(tt.col_indices, g.col_indices)


def test_market_reader(chesapeake):
    # chesapeake: 39 vertices, 170 undirected edges -> 340 directed
    assert chesapeake.num_nodes == 39
    assert chesapeake.num_edges == 340
    assert chesapeake.undirected


def test_market_binary_cache(tmp_path, chesapeake):
    path = tmp_path / "g.mtx"
    path.write_text(
        "%%MatrixMarket matrix coordinate pattern symmetric\n"
        "3 3 2\n2 1\n3 2\n")
    g1 = gt.io.load_market(str(path))
    g2 = gt.io.load_market(str(path))  # cache hit
    assert g1.num_edges == g2.num_edges == 4
    assert np.array_equal(g1.row_offsets, g2.row_offsets)


def test_market_weighted(tmp_path):
    path = tmp_path / "w.mtx"
    path.write_text(
        "%%MatrixMarket matrix coordinate real general\n"
        "2 2 2\n1 2 3.5\n2 1 1.25\n")
    g = gt.io.load_market(str(path), use_cache=False)
    assert g.edge_values is not None
    assert sorted(g.edge_values.tolist()) == [1.25, 3.5]


def test_rmat_deterministic():
    g1 = gt.io.rmat(scale=8, edge_factor=4, seed=7)
    g2 = gt.io.rmat(scale=8, edge_factor=4, seed=7)
    assert g1.num_edges == g2.num_edges
    assert np.array_equal(g1.col_indices, g2.col_indices)
    assert g1.num_nodes == 256


def test_rgg_small_world():
    g = gt.io.rgg(500, seed=3)
    assert g.num_nodes == 500 and g.num_edges > 0
    sw = gt.io.small_world(200, k=4, p=0.1, seed=3)
    assert sw.num_nodes == 200 and sw.num_edges > 0


def test_degree_histogram():
    g = gt.from_coo(4, [0, 0, 0, 1], [1, 2, 3, 2])
    hist = g.degree_histogram()
    assert hist[0] == 2      # vertices 2,3 have degree 0
    assert hist.sum() == 4
    assert g.largest_degree_vertex() == 0


def test_to_device_padding():
    g = gt.from_coo(5, [0, 1, 2], [1, 2, 3])
    d = gt.to_device(g, with_csc=True, with_edge_values=True,
                     with_edge_src=True)
    assert d.v_pad % 128 == 0 and d.e_pad % 128 == 0
    row = np.asarray(d.row_offsets)
    assert row[5:].min() == g.num_edges  # padded vertices degree 0
    # CSC edge destinations are sorted segment ids
    dsts = np.asarray(d.csc_edge_dst)
    assert np.all(np.diff(dsts) >= 0)


def test_write_read_binary(tmp_path):
    g = gt.io.rmat(scale=6, edge_factor=4, seed=1, random_edge_values=True)
    p = str(tmp_path / "g.csr.npz")
    g.write_binary(p)
    g2 = gt.CsrGraph.read_binary(p)
    assert np.array_equal(g.row_offsets, g2.row_offsets)
    assert np.allclose(g.edge_values, g2.edge_values)


def test_sizet64_offsets_oracle(rmat_small):
    """--64bit-SizeT analogue: int64 offsets through BFS/SSSP
    (reference util/test_utils.h)."""
    import jax
    if not jax.config.jax_enable_x64:
        import subprocess, sys, os
        env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu")
        code = (
            "import jax; jax.config.update('jax_platforms','cpu');"
            "import sys; sys.path.insert(0, %r);"
            "import numpy as np, gunrock_jax as gt;"
            "from gunrock_jax.utils.reference import cpu_bfs;"
            "from gunrock_jax.models.bfs import bfs_device;"
            "g = gt.io.rmat(scale=9, edge_factor=6, seed=5, undirected=True);"
            "dg = gt.to_device(g, with_csc=True, sizet64=True);"
            "assert str(dg.row_offsets.dtype) == 'int64', dg.row_offsets.dtype;"
            "lab, _, st = bfs_device(dg, 0, direction_optimized=True);"
            "assert np.array_equal(np.asarray(lab)[:g.num_nodes],"
            " cpu_bfs(g, 0));"
            "print('OK')"
        ) % os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=300)
        assert "OK" in out.stdout, out.stderr[-2000:]
    # sizet64 without x64 mode must fail loudly, not silently downcast
    with pytest.raises(ValueError, match="x64"):
        gt.to_device(rmat_small, sizet64=True)


@pytest.mark.parametrize("n,m", [(1, 0), (127, 300), (128, 128),
                                 (129, 1000), (9000, 20000)])
def test_to_device_padding_shapes(n, m):
    """Vertex and edge arrays pad to LANE multiples; padded rows repeat
    the edge count (degree 0), padded edge slots point at vertex 0 and
    their per-edge row ids carry the v_pad fill."""
    from gunrock_jax.graph.device import LANE
    rng = np.random.default_rng(n)
    g = gt.from_coo(n, rng.integers(0, n, m), rng.integers(0, n, m))
    dg = gt.to_device(g, with_csc=True, with_edge_values=True,
                      with_edge_src=True)
    assert dg.v_pad % LANE == 0 and dg.v_pad >= max(n, 1)
    assert dg.e_pad % LANE == 0 and dg.e_pad >= max(g.num_edges, 1)
    assert dg.v_pad - n < LANE and dg.e_pad - max(g.num_edges, 1) < LANE
    row = np.asarray(dg.row_offsets)
    assert row.shape == (dg.v_pad + 1,)
    np.testing.assert_array_equal(row[:n + 1], g.row_offsets)
    assert (row[n:] == g.num_edges).all()
    col = np.asarray(dg.col_indices)
    np.testing.assert_array_equal(col[:g.num_edges], g.col_indices)
    assert (col[g.num_edges:] == 0).all()
    esrc = np.asarray(dg.edge_src)
    np.testing.assert_array_equal(esrc[:g.num_edges], g.edge_sources())
    assert (esrc[g.num_edges:] == dg.v_pad).all()
    assert (np.asarray(dg.csc_edge_dst)[g.num_edges:] == dg.v_pad).all()
    assert (np.asarray(dg.edge_values)[g.num_edges:] == 0).all()
