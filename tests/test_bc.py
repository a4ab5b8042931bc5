"""BC vs CPU Brandes oracle (reference tests/bc/test_bc.cu)."""

import numpy as np
import pytest

import gunrock_jax as gt
from gunrock_jax.models.bc import bc
from oracles import cpu_bc


def test_bc_single_source_chesapeake(chesapeake):
    res = bc(chesapeake, src=0)
    expected = cpu_bc(chesapeake, src=0)
    np.testing.assert_allclose(res.bc_values, expected, rtol=1e-4,
                               atol=1e-5)


def test_bc_sigma_counts(chesapeake):
    res = bc(chesapeake, src=0)
    # sigma[src]=1; sigma of depth-1 vertices = 1
    assert res.sigmas[0] == 1.0
    depth1 = np.where(res.labels == 1)[0]
    assert (res.sigmas[depth1] >= 1.0).all()


def test_bc_all_sources_small():
    # small cycle + chord: exact BC over all sources
    src = np.array([0, 1, 2, 3, 4, 0])
    dst = np.array([1, 2, 3, 4, 0, 2])
    g = gt.from_coo(5, src, dst, undirected=True)
    res = bc(g, src=-1)
    expected = cpu_bc(g, src=-1)
    np.testing.assert_allclose(res.bc_values, expected, rtol=1e-4,
                               atol=1e-5)


def test_bc_rmat_single_source(rmat_small):
    res = bc(rmat_small, src=3)
    expected = cpu_bc(rmat_small, src=3)
    np.testing.assert_allclose(res.bc_values, expected, rtol=1e-3,
                               atol=1e-4)


def test_bc_deep_graph(road_like):
    res = bc(road_like, src=0)
    expected = cpu_bc(road_like, src=0)
    np.testing.assert_allclose(res.bc_values, expected, rtol=1e-3,
                               atol=1e-4)


def test_bc_instrumented_records_on_push_path(rmat_small):
    """--instrumented must produce per-level records for both
    Brandes phases."""
    res = bc(rmat_small, src=0, instrumented=True)
    recs = res.info["per_iteration"]
    assert recs, "no per-level records"
    phases = {r["phase"] for r in recs}
    assert phases == {"forward", "backward"}
    np.testing.assert_allclose(res.bc_values, cpu_bc(rmat_small, src=0),
                               rtol=1e-3, atol=1e-4)


def test_bc_hybrid_chunked_enactment(rmat_small):
    """Host-chunked Brandes (_bc_hybrid: forward chunks -> argsort ->
    backward chunks) must match the oracle."""
    from gunrock_jax.enactor import capacity_ladder
    from gunrock_jax.models.bc import _bc_hybrid
    import jax
    dg = gt.to_device(rmat_small)
    out = jax.block_until_ready(
        _bc_hybrid(dg, 0, dg.v_pad, tuple(capacity_ladder(dg.e_pad))))
    got = np.asarray(out[0])[: rmat_small.num_nodes] * 0.5
    np.testing.assert_allclose(got, cpu_bc(rmat_small, src=0),
                               rtol=1e-3, atol=1e-4)
