"""HITS / SALSA / WTF / TopK tests (reference tests/{hits,salsa,wtf,topk})."""

import numpy as np
import pytest

import gunrock_jax as gt
from oracles import cpu_hits


@pytest.fixture(scope="module")
def directed_graph():
    # Deterministic directed scale-free-ish graph.
    return gt.io.rmat(scale=8, edge_factor=6, seed=21, undirected=False)


def test_hits_oracle(directed_graph):
    res = gt.hits(directed_graph, max_iters=30)
    hub_exp, auth_exp = cpu_hits(directed_graph, max_iters=30)
    np.testing.assert_allclose(res.hubs, hub_exp, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(res.auths, auth_exp, rtol=1e-3, atol=1e-5)


def test_hits_matches_reference_raw_pingpong(directed_graph):
    """Scale-invariance vs the reference's RAW (unnormalized) ping-pong.

    The reference HITS never normalizes between iterations
    (``hits_enactor.cuh:93-113`` NormalizeRank only swaps+zeroes); our
    per-iteration max-normalize changes only the scale of each vector,
    never the direction. Verify: raw fp64 power iteration, normalized
    once at the end, equals our output (doc/parity.md HITS note).
    """
    g = directed_graph
    iters = 12   # few enough that raw fp64 sums stay finite
    n = g.num_nodes
    src = g.edge_sources()
    hub = np.ones(n)
    auth = np.ones(n)
    for _ in range(iters):
        auth = np.bincount(g.col_indices, weights=hub[src], minlength=n)
        hub = np.bincount(src, weights=auth[g.col_indices], minlength=n)
    auth /= max(auth.max(), 1e-300)
    hub /= max(hub.max(), 1e-300)
    res = gt.hits(g, max_iters=iters)
    np.testing.assert_allclose(res.auths, auth, rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(res.hubs, hub, rtol=2e-3, atol=1e-5)


def test_hits_star():
    # star: 1..4 -> 0. Vertex 0 is the authority; 1..4 are hubs.
    g = gt.from_coo(5, [1, 2, 3, 4], [0, 0, 0, 0])
    res = gt.hits(g, max_iters=5)
    assert res.auths.argmax() == 0
    assert res.auths[0] == 1.0
    assert (res.hubs[1:] == 1.0).all() and res.hubs[0] == 0.0


def test_salsa_mass_conservation(directed_graph):
    res = gt.salsa(directed_graph, max_iters=20)
    # SALSA walk steps conserve mass restricted to non-dangling parts;
    # scores must be finite, non-negative.
    assert np.isfinite(res.hubs).all() and np.isfinite(res.auths).all()
    assert (res.hubs >= 0).all() and (res.auths >= 0).all()
    assert res.auths.sum() > 0


def test_salsa_oracle(directed_graph):
    from oracles import cpu_salsa
    res = gt.salsa(directed_graph, max_iters=20)
    hub_exp, auth_exp = cpu_salsa(directed_graph, max_iters=20)
    np.testing.assert_allclose(res.hubs, hub_exp, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(res.auths, auth_exp, rtol=1e-3, atol=1e-5)


def test_wtf_oracle(directed_graph):
    from oracles import cpu_wtf
    res = gt.wtf(directed_graph, src=0, max_iters=30)
    ref, ppr = cpu_wtf(directed_graph, 0, max_iters=30)
    np.testing.assert_allclose(res.ppr_ranks, ppr, rtol=1e-3, atol=1e-6)
    k = res.scores.shape[0]
    np.testing.assert_allclose(np.sort(res.scores)[::-1],
                               np.sort(ref)[::-1][:k],
                               rtol=1e-3, atol=1e-6)


def test_salsa_cycle_uniform():
    # directed 4-cycle: perfectly symmetric -> uniform scores.
    g = gt.from_coo(4, [0, 1, 2, 3], [1, 2, 3, 0])
    res = gt.salsa(g, max_iters=10)
    np.testing.assert_allclose(res.hubs, res.hubs[0], rtol=1e-5)
    np.testing.assert_allclose(res.auths, res.auths[0], rtol=1e-5)


def test_wtf_runs_and_ranks(directed_graph):
    res = gt.wtf(directed_graph, src=0, max_iters=30)
    assert len(res.node_ids) <= 1000
    # scores sorted descending
    assert (np.diff(res.scores) <= 1e-12).all()
    assert np.isfinite(res.ppr_ranks).all()
    # PPR mass concentrated near src's component
    assert res.ppr_ranks[0] > 0


def test_topk_degree_centrality(rmat_small):
    res = gt.topk(rmat_small, k=10)
    out_deg = np.diff(rmat_small.row_offsets)
    in_deg = np.bincount(rmat_small.col_indices,
                         minlength=rmat_small.num_nodes)
    cent = out_deg + in_deg
    expected = np.sort(cent)[::-1][:10]
    np.testing.assert_array_equal(np.sort(res.centralities)[::-1], expected)
    assert (cent[res.node_ids] == res.centralities).all()


def test_sample_template(rmat_small):
    from oracles import cpu_bfs
    labels = gt.sample(rmat_small, src=0)
    np.testing.assert_array_equal(labels, cpu_bfs(rmat_small, 0))


def test_hits_raw_parity_mode(chesapeake):
    """Raw ping-pong mode reproduces the reference recurrence
    (hits_functor.cuh:91,165; NormalizeRank = swap+zero only)."""
    import gunrock_jax as gt
    from gunrock_jax.models.hits import hits_device

    g = chesapeake
    dg = gt.to_device(g, with_csc=True, with_edge_src=True)
    src, delta, iters = 3, 0.2, 12
    hub, auth = hits_device(dg, max_iters=iters, mode="raw", src=src,
                            delta=delta)
    hub = np.asarray(hub)[: g.num_nodes]
    auth = np.asarray(auth)[: g.num_nodes]

    # numpy float64 oracle of the exact reference recurrence
    n = g.num_nodes
    es, ed = g.edge_sources(), g.col_indices
    outd = np.diff(g.row_offsets).astype(np.float64)
    ind = np.bincount(ed, minlength=n).astype(np.float64)
    inv_out = 1.0 / np.maximum(outd, 1.0)
    inv_in = np.where(ind > 0, 1.0 / np.maximum(ind, 1.0), 0.0)
    h = np.ones(n)
    a = np.ones(n)
    for _ in range(iters):
        a = np.bincount(es, weights=h[ed] * inv_out[ed], minlength=n)
        h = delta * (np.arange(n) == src) + (1 - delta) * np.bincount(
            es, weights=a[ed] * inv_in[ed], minlength=n)
    np.testing.assert_allclose(auth, a, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(hub, h, rtol=2e-4, atol=1e-6)
