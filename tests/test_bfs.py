"""BFS primitive vs CPU oracle (reference tests/bfs/test_bfs.cu model:
whole-primitive output equivalence against a host reference)."""

import numpy as np
import pytest

import gunrock_jax as gt
from oracles import cpu_bfs


def _check_preds(g, labels, preds, src):
    """Any valid BFS tree is accepted (the reference validates preds the
    same way — races make them nondeterministic there; ours are
    deterministic but still just 'a' valid tree)."""
    row, col = g.row_offsets, g.col_indices
    for v in range(g.num_nodes):
        if v == src or labels[v] <= 0:
            continue
        p = preds[v]
        assert p >= 0, f"reached vertex {v} missing pred"
        assert labels[p] == labels[v] - 1
        assert v in col[row[p]:row[p + 1]]


@pytest.mark.parametrize("do", [False, True])
def test_bfs_chesapeake(chesapeake, do):
    res = gt.bfs(chesapeake, src=0, mark_preds=True, direction_optimized=do)
    expected = cpu_bfs(chesapeake, 0)
    np.testing.assert_array_equal(res.labels, expected)
    _check_preds(chesapeake, res.labels, res.preds, 0)
    assert res.info["search_depth"] == int(expected.max())


def test_bfs_bips98(bips98):
    res = gt.bfs(bips98, src=0)
    np.testing.assert_array_equal(res.labels, cpu_bfs(bips98, 0))


@pytest.mark.parametrize("src", [0, 37, 511])
def test_bfs_rmat(rmat_small, src):
    res = gt.bfs(rmat_small, src=src)
    np.testing.assert_array_equal(res.labels, cpu_bfs(rmat_small, src))


def test_bfs_rmat_direction_optimized(rmat_small):
    res = gt.bfs(rmat_small, src=0, direction_optimized=True,
                 mark_preds=True)
    np.testing.assert_array_equal(res.labels, cpu_bfs(rmat_small, 0))
    _check_preds(rmat_small, res.labels, res.preds, 0)


def test_bfs_deep_graph(road_like):
    """High-diameter grid exercises many iterations + the small-capacity
    ladder rungs."""
    res = gt.bfs(road_like, src=0)
    expected = cpu_bfs(road_like, 0)
    np.testing.assert_array_equal(res.labels, expected)
    assert res.info["search_depth"] == 62  # 31+31 grid diameter


def test_bfs_unreachable():
    g = gt.from_coo(6, [0, 1], [1, 0], undirected=False, dedup=False)
    res = gt.bfs(g, src=0)
    assert res.labels[0] == 0 and res.labels[1] == 1
    assert (res.labels[2:] == -1).all()


def test_bfs_largest_degree_source(rmat_small):
    res = gt.bfs(rmat_small, src="largestdegree")
    expected = cpu_bfs(rmat_small, rmat_small.largest_degree_vertex())
    np.testing.assert_array_equal(res.labels, expected)


def test_bfs_deterministic(rmat_small):
    """Bitwise-reproducible outputs — stronger than the reference, whose
    atomics make preds race-dependent."""
    r1 = gt.bfs(rmat_small, src=3, mark_preds=True)
    r2 = gt.bfs(rmat_small, src=3, mark_preds=True)
    np.testing.assert_array_equal(r1.labels, r2.labels)
    np.testing.assert_array_equal(r1.preds, r2.preds)


def test_bfs_info_record(rmat_small):
    res = gt.bfs(rmat_small, src=0)
    info = res.info
    assert info["primitive"] == "bfs"
    assert info["num_vertices"] == rmat_small.num_nodes
    assert info["edges_visited"] > 0
    assert info["m_teps"] > 0
    assert len(info["per_iteration_frontier"]) == info["num_iterations"]
    assert sum(info["per_iteration_frontier"]) == info["nodes_queued"]


def test_bfs_chunked_enactment(road_like):
    """Multi-chunk host enactment (tiny chunks force several device
    calls + convergence probes) must match the single-chunk result."""
    from gunrock_jax.models.bfs import bfs_device
    import jax
    dg = gt.to_device(road_like)
    ref = jax.block_until_ready(bfs_device(dg, 0))
    got = jax.block_until_ready(bfs_device(dg, 0, chunk_iters=7))
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(ref[0]))
    assert int(got[2].iteration) == int(ref[2].iteration)


def test_bfs_instrumented_per_iteration_records(rmat_small):
    res = gt.bfs(rmat_small, src=0, direction_optimized=True,
                 instrumented=True)
    from oracles import cpu_bfs
    np.testing.assert_array_equal(res.labels, cpu_bfs(rmat_small, 0))
    rec = res.info["per_iteration"]
    assert len(rec) == res.info["search_depth"] or \
        len(rec) == res.info["search_depth"] + 1
    assert all(r["ms"] > 0 for r in rec)
    assert any(r["pull"] for r in rec)  # scale-free: pull must engage
    # per-kernel duty split (reference util/kernel_runtime_stats.cuh):
    # every record is attributed to a phase and the aggregate exists
    assert all(r["phase"] in ("push", "pull", "deep") for r in rec)
    assert any(r["phase"] == "pull" for r in rec)
    split = res.info["phase_ms"]
    assert set(split) == {r["phase"] for r in rec}
    total = sum(split.values())
    assert abs(total - sum(r["ms"] for r in rec)) < 0.1 * total + 1e-6
    assert res.info["phase_iterations"]["pull"] >= 1


def test_bfs_instrumented_deep_phase_on_grid(road_big):
    res = gt.bfs(road_big, src=0, instrumented=True)
    rec = res.info["per_iteration"]
    # a 382-diameter grid runs almost entirely in the micro-loop
    assert res.info["phase_iterations"].get("deep", 0) > \
        res.info["phase_iterations"].get("push", 0)
    assert all(r["phase"] in ("push", "deep") for r in rec)


def test_bfs_deep_micro_loop(road_big):
    """Grid big enough that the deep-regime micro while_loop engages
    (models/bfs.py _make_deep_loop); whole level stretches run at
    DEEP_CAP scale. Validates labels + preds against the oracle."""
    res = gt.bfs(road_big, src=0, mark_preds=True)
    np.testing.assert_array_equal(res.labels, cpu_bfs(road_big, 0))
    assert res.info["search_depth"] == 382  # 191+191 grid diameter
    _check_preds(road_big, res.labels, res.preds, 0)
