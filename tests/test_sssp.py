"""SSSP vs CPU Dijkstra oracle (reference tests/sssp/test_sssp.cu)."""

import numpy as np
import pytest

import gunrock_jax as gt
from gunrock_jax.models.sssp import sssp
from oracles import cpu_sssp


@pytest.fixture(scope="module")
def weighted_rmat():
    g = gt.io.rmat(scale=9, edge_factor=6, seed=11, undirected=True,
                   random_edge_values=True)
    return g


@pytest.mark.parametrize("mode", ["bellman", "nearfar"])
def test_sssp_rmat(weighted_rmat, mode):
    res = sssp(weighted_rmat, src=0, mode=mode)
    expected = cpu_sssp(weighted_rmat, 0)
    np.testing.assert_allclose(res.distances, expected, rtol=1e-5)


def test_sssp_chesapeake(chesapeake):
    chesapeake.random_edge_values(seed=5)
    res = sssp(chesapeake, src=3, mark_preds=True)
    expected = cpu_sssp(chesapeake, 3)
    np.testing.assert_allclose(res.distances, expected, rtol=1e-5)
    # Validate the shortest-path tree: dist[v] == dist[pred[v]] + w(pred, v)
    row, col, w = (chesapeake.row_offsets, chesapeake.col_indices,
                   chesapeake.edge_values)
    for v in range(chesapeake.num_nodes):
        if v == 3 or not np.isfinite(res.distances[v]):
            continue
        p = res.preds[v]
        assert p >= 0
        edges = [e for e in range(row[p], row[p + 1]) if col[e] == v]
        assert edges, f"pred {p} not adjacent to {v}"
        assert any(np.isclose(res.distances[v], res.distances[p] + w[e],
                              rtol=1e-5) for e in edges)


def test_sssp_unit_weights(road_like):
    """Unit weights -> distances equal BFS depths."""
    road_like.edge_values = np.ones(road_like.num_edges, np.float32)
    res = sssp(road_like, src=0)
    bfs_res = gt.bfs(road_like, src=0)
    np.testing.assert_allclose(res.distances,
                               bfs_res.labels.astype(np.float32))


def test_sssp_deterministic(weighted_rmat):
    r1 = sssp(weighted_rmat, src=7, mark_preds=True)
    r2 = sssp(weighted_rmat, src=7, mark_preds=True)
    np.testing.assert_array_equal(r1.distances, r2.distances)
    np.testing.assert_array_equal(r1.preds, r2.preds)


def test_sssp_nearfar_matches_bellman(weighted_rmat):
    a = sssp(weighted_rmat, src=5, mode="bellman")
    b = sssp(weighted_rmat, src=5, mode="nearfar")
    np.testing.assert_allclose(a.distances, b.distances, rtol=1e-5)


def test_sssp_chunked_enactment(weighted_rmat):
    from gunrock_jax.models.sssp import sssp_device
    import jax
    dg = gt.to_device(weighted_rmat, with_edge_values=True)
    ref = jax.block_until_ready(sssp_device(dg, 3))
    got = jax.block_until_ready(sssp_device(dg, 3, chunk_iters=2))
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(ref[0]))


def test_sssp_deep_micro_queue(road_big):
    """Grid big enough that the near-far micro-queue engages
    (models/sssp.py _make_deep_loop): rung-scale rounds relax only the
    sub-threshold subset with a sort-dedup queue merge. Validates both
    modes against Dijkstra. Copies the session fixture before weighting
    it so other tests never see the mutated edge values."""
    import dataclasses as _dc
    g = _dc.replace(road_big)
    g.random_edge_values(seed=11)
    want = cpu_sssp(g, 0)
    for mode in ("bellman", "nearfar"):
        r = sssp(g, src=0, mode=mode)
        np.testing.assert_allclose(r.distances, want, rtol=1e-5)


def test_sssp_deep_micro_queue_value_carry(road_big, monkeypatch):
    """Queue value-carry (GUNROCK_SSSP_CARRY=1): (dist, degree) ride the
    micro-loop state instead of per-round big-array gathers. Must be
    bitwise-identical to the uncarried micro loop — the carried dist is
    exact (every improvement re-enqueues through the min-keeping merge)
    and relaxation still routes through _winner_minimize."""
    import dataclasses as _dc
    import jax
    from gunrock_jax.models.sssp import sssp_device
    g = _dc.replace(road_big)
    g.random_edge_values(seed=11)
    want = cpu_sssp(g, 0)
    dg = gt.to_device(g, with_edge_values=True)
    for mode in ("bellman", "nearfar"):
        base = jax.block_until_ready(
            sssp_device(dg, 0, mode=mode, delta=300.0))
        got = jax.block_until_ready(
            sssp_device(dg, 0, mode=mode, delta=300.0, deep_carry=True))
        np.testing.assert_array_equal(np.asarray(got[0]),
                                      np.asarray(base[0]))
        np.testing.assert_allclose(
            np.asarray(got[0])[: g.num_nodes], want, rtol=1e-5)


def test_sssp_instrumented_phase_split(rmat_small):
    """--instrumented attributes every round to a kernel phase and the
    info record aggregates the duty split (reference per-kernel stats,
    util/kernel_runtime_stats.cuh + enactor_types.cuh:67-72)."""
    res = gt.sssp(rmat_small, src=0, instrumented=True)
    np.testing.assert_allclose(res.distances, cpu_sssp(rmat_small, 0),
                               rtol=1e-5)
    rec = res.info["per_iteration"]
    assert rec and all(r["phase"] in ("push", "pull", "deep")
                       for r in rec)
    split = res.info["phase_ms"]
    assert set(split) == {r["phase"] for r in rec}
    assert sum(res.info["phase_iterations"].values()) == len(rec)
