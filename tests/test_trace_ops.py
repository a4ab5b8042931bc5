"""The trace reduction of ``tools/trace_ops.py``, checked on the CPU."""

import glob
import os
import sys

import jax
import jax.numpy as jnp
import pytest

import conftest  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import trace_ops  # noqa: E402


@pytest.mark.parametrize("events,busy_ns", [
    ([], 0),
    ([("a", 0, 10)], 10),
    ([("a", 0, 10), ("b", 20, 5)], 15),            # a gap is idle
    ([("a", 0, 10), ("b", 5, 10)], 15),            # overlap counts once
    ([("a", 0, 30), ("b", 5, 10), ("a", 40, 1)], 31),  # nested span
])
def test_reduce_events_busy_is_union(events, busy_ns):
    rec = trace_ops.reduce_events(events)
    assert rec["busy_ms"] == pytest.approx(busy_ns / 1e6)


def test_reduce_events_ranks_by_total_time():
    ev = [("x", 0, 5), ("y", 10, 3), ("x", 20, 5), ("z", 30, 1)]
    rec = trace_ops.reduce_events(ev, top=2)
    assert rec["top"] == [["x", 2, pytest.approx(10e-6)],
                          ["y", 1, pytest.approx(3e-6)]]


def test_device_events_reads_a_trace(tmp_path):
    """On the CPU the XLA ops land on the host plane; the reader finds
    them there, and finds nothing on a GPU plane."""
    f = jax.jit(lambda x: jnp.cumsum(x * 2.0).sum())
    x = jnp.arange(4096.0)
    f(x).block_until_ready()
    jax.profiler.start_trace(str(tmp_path))
    f(x).block_until_ready()
    jax.profiler.stop_trace()
    (pb,) = glob.glob(str(tmp_path / "**" / "*.xplane.pb"), recursive=True)
    host = trace_ops.device_events(pb, plane_prefix="/host:CPU")
    assert host and all(dur >= 0 for _, _, dur in host)
    assert trace_ops.device_events(pb) == []


def test_main_refuses_cpu(capsys):
    assert trace_ops.main(["--scale", "4"]) != 0
    assert "no GPU" in capsys.readouterr().err
