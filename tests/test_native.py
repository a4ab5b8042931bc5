"""Native C++ host graph builder vs the numpy fallback."""

import numpy as np
import pytest

import conftest  # noqa: F401
import gunrock_jax as gt
from gunrock_jax.graph import native


@pytest.fixture(scope="module")
def lib_available():
    if not native.native_available():
        pytest.skip("native toolchain unavailable")


def _fresh(monkeypatch, disable: bool):
    if disable:
        monkeypatch.setenv("GUNROCK_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("GUNROCK_NO_NATIVE", raising=False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)


def test_native_matches_numpy(lib_available, monkeypatch):
    rng = np.random.default_rng(3)
    n, e = 2000, 60000
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    vals = rng.random(e).astype(np.float32)

    _fresh(monkeypatch, disable=False)
    g_nat = gt.from_coo(n, src, dst, vals, undirected=True)
    _fresh(monkeypatch, disable=True)
    g_np = gt.from_coo(n, src, dst, vals, undirected=True)

    assert np.array_equal(g_nat.row_offsets, g_np.row_offsets)
    assert np.array_equal(g_nat.col_indices, g_np.col_indices)
    assert np.allclose(g_nat.edge_values, g_np.edge_values)


def test_native_no_dedup_no_selfloop_removal(lib_available, monkeypatch):
    src = np.array([0, 0, 1, 1, 2])
    dst = np.array([1, 1, 0, 1, 2])
    _fresh(monkeypatch, disable=False)
    g = gt.from_coo(3, src, dst, remove_self_loops=False, dedup=False)
    assert g.num_edges == 5
    g2 = gt.from_coo(3, src, dst, remove_self_loops=True, dedup=True)
    assert g2.num_edges == 2  # 0->1, 1->0


def test_native_market_body(lib_available):
    body = b"1 2 0.5\n2 3 1.5\n3 1 2.5\n"
    out = native.parse_market_body_native(body, 3, True)
    assert out is not None
    src, dst, vals = out
    assert src.tolist() == [0, 1, 2]
    assert dst.tolist() == [1, 2, 0]
    assert np.allclose(vals, [0.5, 1.5, 2.5])


def test_native_market_body_pattern(lib_available):
    body = b"% a comment inside\n1 2\n3 4\n"
    out = native.parse_market_body_native(body, 4, False)
    src, dst, vals = out
    assert src.tolist() == [0, 2] and dst.tolist() == [1, 3]
    assert vals is None
