"""Multi-chip tests on the virtual 8-device CPU mesh (the reference's
``--device=0,0`` multi-GPU-without-a-cluster trick, CMakeLists:389-421)."""

import numpy as np
import pytest

import gunrock_jax as gt
from gunrock_jax.parallel import (bfs_sharded, make_mesh, pagerank_sharded,
                                  partition, sssp_sharded)
from oracles import cpu_bfs, cpu_pagerank, cpu_sssp


@pytest.mark.parametrize("n, m, dtype", [(1, 5, np.int32), (37, 500, np.int32),
                                         (1 << 20, 4000, np.int64)])
def test_pair_order_matches_lexsort(n, m, dtype):
    from gunrock_jax.parallel.partition import _pair_order
    rng = np.random.default_rng(n)
    major = rng.integers(0, n, m).astype(dtype)
    minor = rng.integers(0, n, m).astype(dtype)
    np.testing.assert_array_equal(_pair_order(major, minor, n),
                                  np.lexsort((minor, major)))


def test_partition_static_roundtrip(rmat_small):
    pg, perm = partition(rmat_small, 4, method="static")
    assert pg.num_shards == 4
    assert pg.shard_size % 128 == 0
    # every vertex maps to exactly one relabeled slot
    assert len(np.unique(perm)) == rmat_small.num_nodes
    # static: owners are contiguous chunks in old order
    owners = perm // pg.shard_size
    assert (np.diff(owners) >= 0).all()


@pytest.mark.parametrize("method", ["static", "random", "biasrandom",
                                    "cluster", "metis"])
def test_partition_methods_preserve_edges(method, rmat_small):
    pg, perm = partition(rmat_small, 4, method=method, seed=1)
    # total stored edges match
    row = np.asarray(pg.row_offsets)
    assert int(row[:, -1].sum()) == rmat_small.num_edges
    # spot-check adjacency of vertex 0 survives relabeling
    old_nbrs = rmat_small.col_indices[
        rmat_small.row_offsets[0]:rmat_small.row_offsets[1]]
    new0 = perm[0]
    s, l = divmod(int(new0), pg.shard_size)
    col = np.asarray(pg.col_indices)
    nbrs_new = col[s, row[s, l]:row[s, l + 1]]
    assert sorted(nbrs_new.tolist()) == sorted(perm[old_nbrs].tolist())


def test_biasrandom_balances_degrees(rmat_small):
    pg, perm = partition(rmat_small, 4, method="biasrandom")
    owners = perm // pg.shard_size
    deg = np.diff(rmat_small.row_offsets)
    per_shard = np.bincount(owners, weights=deg, minlength=4)
    assert per_shard.max() / max(per_shard.mean(), 1) < 1.3


@pytest.mark.parametrize("num_shards", [2, 4, 8])
def test_bfs_sharded_matches_oracle(rmat_small, num_shards):
    res = bfs_sharded(rmat_small, src=0, num_shards=num_shards,
                      partition_method="random", seed=3)
    np.testing.assert_array_equal(res.labels, cpu_bfs(rmat_small, 0))


@pytest.mark.parametrize("method", ["static", "cluster", "biasrandom"])
def test_bfs_sharded_partition_methods(rmat_small, method):
    res = bfs_sharded(rmat_small, src=5, num_shards=4,
                      partition_method=method)
    np.testing.assert_array_equal(res.labels, cpu_bfs(rmat_small, 5))


def test_bfs_sharded_preds_valid(chesapeake):
    res = bfs_sharded(chesapeake, src=0, num_shards=4, mark_preds=True)
    expected = cpu_bfs(chesapeake, 0)
    np.testing.assert_array_equal(res.labels, expected)
    row, col = chesapeake.row_offsets, chesapeake.col_indices
    for v in range(chesapeake.num_nodes):
        if v == 0 or res.labels[v] <= 0:
            continue
        pv = res.preds[v]
        assert pv >= 0
        assert res.labels[pv] == res.labels[v] - 1
        assert v in col[row[pv]:row[pv + 1]]


def test_bfs_sharded_deep_graph(road_like):
    res = bfs_sharded(road_like, src=0, num_shards=4)
    np.testing.assert_array_equal(res.labels, cpu_bfs(road_like, 0))


def test_bfs_sharded_matches_single_chip(rmat_small):
    multi = bfs_sharded(rmat_small, src=2, num_shards=8)
    single = gt.bfs(rmat_small, src=2)
    np.testing.assert_array_equal(multi.labels, single.labels)


@pytest.mark.parametrize("num_shards", [2, 8])
def test_pagerank_sharded(rmat_small, num_shards):
    res = pagerank_sharded(rmat_small, num_shards=num_shards,
                           max_iters=100, threshold=1e-9)
    expected = cpu_pagerank(rmat_small, max_iters=100, tol=1e-9)
    np.testing.assert_allclose(res.ranks, expected, rtol=1e-3)


def test_pagerank_sharded_matches_single_chip(rmat_small):
    from gunrock_jax.models.pr import pagerank
    multi = pagerank_sharded(rmat_small, num_shards=4, max_iters=40,
                             threshold=1e-8)
    single = pagerank(rmat_small, max_iters=40, threshold=1e-8)
    np.testing.assert_allclose(multi.ranks, single.ranks, rtol=2e-3,
                               atol=1e-7)


@pytest.mark.parametrize("num_shards", [2, 4])
def test_sssp_sharded(num_shards):
    g = gt.io.rmat(scale=9, edge_factor=6, seed=11, undirected=True,
                   random_edge_values=True)
    res = sssp_sharded(g, src=0, num_shards=num_shards)
    expected = cpu_sssp(g, 0)
    np.testing.assert_allclose(res.distances, expected, rtol=1e-5)


def test_sssp_sharded_deep(road_like):
    road_like.edge_values = np.ones(road_like.num_edges, np.float32)
    res = sssp_sharded(road_like, src=0, num_shards=4)
    expected = cpu_sssp(road_like, 0)
    np.testing.assert_allclose(res.distances, expected, rtol=1e-5)


@pytest.mark.parametrize("num_shards", [2, 4])
def test_cc_sharded_matches_oracle(rmat_small, num_shards):
    from gunrock_jax.parallel import cc_sharded
    from oracles import cpu_cc
    res = cc_sharded(rmat_small, num_shards=num_shards)
    ref = cpu_cc(rmat_small)
    assert res.num_components == len(np.unique(ref))
    # identical partitions: same-component iff same ref component
    np.testing.assert_array_equal(res.components, ref)


def test_cc_sharded_disconnected():
    from gunrock_jax.parallel import cc_sharded
    # two cliques + an isolated vertex
    src = np.array([0, 1, 2, 4, 5, 6])
    dst = np.array([1, 2, 0, 5, 6, 4])
    g = gt.from_coo(8, src, dst, undirected=True)
    res = cc_sharded(g, num_shards=2)
    assert res.num_components == 4  # {0,1,2}, {4,5,6}, {3}, {7}
    assert res.components[0] == res.components[1] == res.components[2] == 0
    assert res.components[4] == res.components[5] == res.components[6] == 4


@pytest.mark.parametrize("num_shards", [2, 4])
def test_bc_sharded_matches_oracle(rmat_small, num_shards):
    from gunrock_jax.parallel import bc_sharded
    from oracles import cpu_bc
    res = bc_sharded(rmat_small, src=0, num_shards=num_shards)
    ref = cpu_bc(rmat_small, 0)
    np.testing.assert_allclose(res.bc_values, ref, rtol=1e-4, atol=1e-4)


def test_bc_sharded_matches_single_chip(chesapeake):
    from gunrock_jax.parallel import bc_sharded
    res = bc_sharded(chesapeake, src="largestdegree", num_shards=4,
                     partition_method="biasrandom")
    single = gt.bc(chesapeake, chesapeake.largest_degree_vertex())
    np.testing.assert_allclose(res.bc_values, single.bc_values,
                               rtol=1e-4, atol=1e-4)


def test_lp_partitioner_beats_random_on_boundary(rmat_small):
    from gunrock_jax.parallel.partition import (_assignment,
                                                boundary_fraction)
    lp, _ = _assignment(rmat_small, "metis", 8, 0)
    rnd, _ = _assignment(rmat_small, "random", 8, 0)
    bf_lp = boundary_fraction(rmat_small, lp)
    bf_rnd = boundary_fraction(rmat_small, rnd)
    assert bf_lp < bf_rnd
    # balance: no shard more than ~15% over the even split
    sizes = np.bincount(lp, minlength=8)
    assert sizes.max() <= 1.15 * -(-rmat_small.num_nodes // 8)


def test_multilevel_partitioner_beats_lp_on_both_families(rmat_small):
    # The multilevel coarsen/partition/refine pipeline must not lose to
    # the single-level LP stand-in on either graph family — power-law
    # (rmat) or mesh-like (grid), where local moves alone can't escape a
    # bad random start (VERDICT r3 item 7).
    from gunrock_jax.parallel.partition import (boundary_fraction,
                                                label_propagation,
                                                multilevel_partition)
    n = 48
    idx = np.arange(n * n).reshape(n, n)
    gsrc = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    gdst = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    grid = gt.from_coo(n * n, gsrc, gdst, undirected=True)
    for g in (rmat_small, grid):
        ml = boundary_fraction(g, multilevel_partition(g, 8, seed=0))
        lp = boundary_fraction(g, label_propagation(g, 8, seed=0))
        assert ml <= lp * 1.02, (ml, lp)
    # mesh cuts specifically must be near-planar quality: an 8-way cut of
    # an n x n grid has a ~7n lower bound; multilevel should be within a
    # small factor of it, far below random's 7/8 of edges
    ml_grid = boundary_fraction(grid, multilevel_partition(grid, 8, seed=0))
    assert ml_grid < 0.12, ml_grid


def test_multilevel_partitioner_balanced_and_deterministic(rmat_small):
    from gunrock_jax.parallel.partition import multilevel_partition
    lab1 = multilevel_partition(rmat_small, 8, seed=3)
    lab2 = multilevel_partition(rmat_small, 8, seed=3)
    np.testing.assert_array_equal(lab1, lab2)
    sizes = np.bincount(lab1, minlength=8)
    assert sizes.max() <= 1.15 * -(-rmat_small.num_nodes // 8)
    assert sizes.min() > 0


def test_partitioners_vectorized_slots_dense(rmat_small):
    from gunrock_jax.parallel.partition import _assignment
    for method in ("biasrandom", "cluster", "metis"):
        shard_of, slot = _assignment(rmat_small, method, 4, 0)
        for s in range(4):
            sl = np.sort(slot[shard_of == s])
            np.testing.assert_array_equal(sl, np.arange(len(sl)))


def test_bfs_sharded_overflow_retries_to_completion(rmat_small):
    # Tiny sizing forces per-peer overflow; the auto-retry must still
    # return complete oracle-equal labels (never silent partial results).
    res = bfs_sharded(rmat_small, src=0, num_shards=4,
                      queue_sizing=0.01, in_sizing=0.01)
    np.testing.assert_array_equal(res.labels, cpu_bfs(rmat_small, 0))
    assert not res.info["frontier_overflow"]


def test_sssp_sharded_overflow_retries_to_completion():
    g = gt.io.rmat(scale=9, edge_factor=6, seed=11, undirected=True,
                   random_edge_values=True)
    res = sssp_sharded(g, src=0, num_shards=4, queue_sizing=0.02,
                       in_sizing=0.02)
    np.testing.assert_allclose(res.distances, cpu_sssp(g, 0), rtol=1e-5)
    assert not res.info["frontier_overflow"]


@pytest.mark.parametrize("num_shards", [2, 8])
def test_bfs_sharded_direction_optimized(rmat_small, num_shards):
    res = bfs_sharded(rmat_small, src=0, num_shards=num_shards,
                      direction_optimized=True)
    np.testing.assert_array_equal(res.labels, cpu_bfs(rmat_small, 0))
    # scale-free graph: the vote must actually take pull iterations
    assert res.info["pull_iterations"] >= 1
    assert len(res.info["direction_trace"]) == res.info["num_iterations"]


def test_bfs_sharded_do_matches_single_chip_bitwise(rmat_small):
    multi = bfs_sharded(rmat_small, src=2, num_shards=8,
                        direction_optimized=True)
    single = gt.bfs(rmat_small, src=2, direction_optimized=True)
    np.testing.assert_array_equal(multi.labels, single.labels)


def test_bfs_sharded_do_preds_valid(rmat_small):
    res = bfs_sharded(rmat_small, src=1, num_shards=4,
                      direction_optimized=True, mark_preds=True)
    expected = cpu_bfs(rmat_small, 1)
    np.testing.assert_array_equal(res.labels, expected)
    row, col = rmat_small.row_offsets, rmat_small.col_indices
    for v in range(rmat_small.num_nodes):
        if res.labels[v] <= 0:
            continue
        pv = res.preds[v]
        assert pv >= 0, v
        assert res.labels[pv] == res.labels[v] - 1
        assert v in col[row[pv]:row[pv + 1]]


def test_bfs_sharded_comm_bytes_and_latency_knob(rmat_small):
    base = bfs_sharded(rmat_small, src=0, num_shards=4,
                       direction_optimized=True)
    assert base.info["comm_bytes"] > 0
    slow = bfs_sharded(rmat_small, src=0, num_shards=4,
                       direction_optimized=True, comm_latency=50)
    np.testing.assert_array_equal(slow.labels, base.labels)
    assert slow.info["comm_latency_rounds"] == 50


def test_ghost_tables_boundary_smaller_than_v(rmat_small):
    # the point of boundary-only exchange: ghosts per peer < shard size
    pg, _ = partition(rmat_small, 8, method="cluster", with_ghosts=True)
    assert pg.has_ghosts
    assert pg.ghost_cap <= pg.shard_size
    # csc_local indexes stay inside the compact local table
    cl = np.asarray(pg.csc_local)
    assert cl.max() < pg.shard_size + 8 * pg.ghost_cap


def test_pr_comm_bytes_reported(rmat_small):
    res = pagerank_sharded(rmat_small, num_shards=4, max_iters=10)
    assert res.info["comm_bytes_per_superstep"] > 0
    # boundary exchange must beat the all-gather volume p*S*4 per shard
    pg, _ = partition(rmat_small, 4, method="random", with_ghosts=True)
    allgather = 4 * pg.shard_size * 4 * 4  # p shards each gather p*S vals
    assert res.info["comm_bytes_per_superstep"] <= allgather


def test_bfs_batch_replicated_matches_oracle(rmat_small):
    from gunrock_jax.parallel import bfs_batch
    sources = [0, 3, 7, 11, 19]
    res = bfs_batch(rmat_small, sources, queue_sizing=1.0)
    assert res.labels.shape == (5, rmat_small.num_nodes)
    for i, s in enumerate(sources):
        np.testing.assert_array_equal(res.labels[i], cpu_bfs(rmat_small, s))
    assert res.info["partition_method"] == "duplicate"


def test_bc_batch_replicated_matches_sum_of_singles(chesapeake):
    from gunrock_jax.parallel import bc_batch
    sources = [0, 5, 9]
    res = bc_batch(chesapeake, sources)
    expected = np.zeros(chesapeake.num_nodes, np.float64)
    for s in sources:
        expected += gt.bc(chesapeake, s).bc_values
    np.testing.assert_allclose(res.bc_values, expected, rtol=1e-4,
                               atol=1e-5)


def test_sssp_sharded_nearfar_matches_oracle():
    g = gt.io.rmat(scale=9, edge_factor=8, seed=5, undirected=True)
    g.random_edge_values(seed=2)
    res = sssp_sharded(g, src=0, num_shards=4, mode="nearfar")
    np.testing.assert_allclose(res.distances, cpu_sssp(g, 0), rtol=1e-5)
    assert res.info["mode"] == "nearfar"


def test_sssp_sharded_nearfar_deep(road_like):
    """High-diameter grid through sharded near-far delta-stepping."""
    road_like.random_edge_values(seed=3)
    res = sssp_sharded(road_like, src=0, num_shards=4, mode="nearfar")
    np.testing.assert_allclose(res.distances, cpu_sssp(road_like, 0),
                               rtol=1e-5)


def test_hits_sharded_matches_single(rmat_small):
    from gunrock_jax.parallel.hits import hits_sharded
    from gunrock_jax.models.hits import hits
    ref = hits(rmat_small, max_iters=10)
    got = hits_sharded(rmat_small, num_shards=8, max_iters=10)
    np.testing.assert_allclose(got.hubs, ref.hubs, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got.auths, ref.auths, rtol=2e-4,
                               atol=2e-5)


def test_salsa_sharded_matches_single(rmat_small):
    from gunrock_jax.parallel.hits import salsa_sharded
    from gunrock_jax.models.salsa import salsa
    ref = salsa(rmat_small, max_iters=10)
    got = salsa_sharded(rmat_small, num_shards=8, max_iters=10)
    np.testing.assert_allclose(got.hubs, ref.hubs, rtol=2e-4, atol=1e-7)
    np.testing.assert_allclose(got.auths, ref.auths, rtol=2e-4,
                               atol=1e-7)


def test_wtf_sharded_matches_single(rmat_small):
    from gunrock_jax.parallel.wtf import wtf_sharded
    from gunrock_jax.models.wtf import wtf
    # threshold=0 pins phase-1 to exactly max_iters on both paths, so
    # the comparison is iteration-for-iteration.
    ref = wtf(rmat_small, src=3, max_iters=10, threshold=0.0)
    got = wtf_sharded(rmat_small, src=3, max_iters=10, threshold=0.0,
                      num_shards=8)
    assert got.info["ppr_iterations"] == ref.info["ppr_iterations"]
    np.testing.assert_allclose(got.ppr_ranks, ref.ppr_ranks, rtol=2e-4,
                               atol=1e-7)
    # The circle-of-trust tie-break (original id) matches single-chip
    # lax.top_k, so per-vertex refscores agree to float tolerance.
    got_scores = dict(zip(got.node_ids.tolist(), got.scores.tolist()))
    for nid, score in zip(ref.node_ids[:50].tolist(),
                          ref.scores[:50].tolist()):
        assert nid in got_scores
        np.testing.assert_allclose(got_scores[nid], score, rtol=2e-4,
                                   atol=1e-7)
    assert set(got.node_ids[:20].tolist()) == set(ref.node_ids[:20].tolist())


def test_topk_sharded_matches_single(rmat_small):
    from gunrock_jax.parallel.topk import topk_sharded
    from gunrock_jax.models.topk import topk
    ref = topk(rmat_small, k=16)
    got = topk_sharded(rmat_small, k=16, num_shards=8)
    # id order may differ among equal centralities; the multiset and the
    # per-id values must match exactly.
    np.testing.assert_array_equal(np.sort(got.centralities),
                                  np.sort(ref.centralities))
    deg = np.diff(rmat_small.row_offsets) + \
        np.diff(rmat_small.csc().row_offsets)
    for i, v in zip(got.node_ids, got.centralities):
        assert deg[i] == v


def test_tc_sharded_matches_single(rmat_small):
    from gunrock_jax.parallel.tc import tc_sharded
    from gunrock_jax.models.tc import tc
    ref = tc(rmat_small)
    got = tc_sharded(rmat_small, num_shards=8)
    assert got.total == ref.total
    np.testing.assert_array_equal(got.vertex_counts, ref.vertex_counts)
