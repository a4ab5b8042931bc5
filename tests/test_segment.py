"""``ops.segment.row_reduce_sorted`` against numpy, per operator, on
random rows, empty rows, padded edge slots and a sum whose running
total dwarfs the rows after it."""

import jax.numpy as jnp
import numpy as np
import pytest

from gunrock_jax.ops.segment import row_reduce_sorted


def _case(kind):
    rng = np.random.default_rng(7)
    if kind == "random":
        deg = rng.integers(1, 9, 40)
        vals = rng.normal(size=int(deg.sum())).astype(np.float32)
        pad = 0
    elif kind == "empty_rows":
        deg = rng.integers(0, 4, 60) * (rng.random(60) < 0.5)
        vals = rng.normal(size=int(deg.sum())).astype(np.float32)
        pad = 0
    elif kind == "padded":
        # Padding slots past row_offsets[-1] hold garbage; padded rows
        # repeat the edge count (DeviceGraph's invariants).
        deg = np.r_[rng.integers(0, 6, 30), np.zeros(10, np.int64)]
        vals = rng.normal(size=int(deg.sum())).astype(np.float32)
        pad = 37
    else:   # cancellation
        deg = np.r_[np.full(4, 1024), np.full(64, 3)]
        vals = np.r_[np.full(4096, 3e4, np.float32),
                     rng.uniform(1e-4, 2e-4, 192).astype(np.float32)]
        pad = 0
    offs = np.zeros(deg.size + 1, np.int64)
    np.cumsum(deg, out=offs[1:])
    padded = np.r_[vals, np.full(pad, 1e9, np.float32)]
    return offs, vals, padded


@pytest.mark.parametrize("kind", ["random", "empty_rows", "padded",
                                  "cancellation"])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_row_reduce_sorted_matches_numpy(op, kind):
    offs, vals, padded = _case(kind)
    got = np.asarray(row_reduce_sorted(
        jnp.asarray(padded), jnp.asarray(offs.astype(np.int32)), op=op))
    expect = []
    for a, b in zip(offs[:-1], offs[1:]):
        seg = vals[a:b].astype(np.float64)
        if op == "sum":
            expect.append(seg.sum())
        elif op == "min":
            expect.append(seg.min() if seg.size else np.inf)
        else:
            expect.append(seg.max() if seg.size else -np.inf)
    expect = np.asarray(expect)
    if op == "sum":
        np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, expect.astype(np.float32))
