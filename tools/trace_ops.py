"""Device time per XLA op of the main queries, from a ``jax.profiler`` trace.

Builds the Kronecker graph of ``chip_smoke.py`` (``--scale``, default 22),
uploads it once, warms each query up, then traces one call of each query
in a window of its own and reduces the trace's GPU plane to one JSON line
per query:

  window_ms   host clock around the traced call (ends in block_until_ready)
  busy_ms     union of the device op intervals in the window
  idle_share  1 - busy_ms / window_ms
  top         the ops with the most device time: [hlo module:op, calls, ms]

The DO-BFS line also carries the pull step's share of its device time:
the full-edge pull pass is traced on its own (its cost does not depend on
the frontier) and multiplied by the number of levels the direction vote
sent to pull.

  python tools/trace_ops.py [--scale N] [--top K] [--out DIR]

Needs a GPU. Traces are written under ``--out`` (default
``chiprun_out/trace``).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def reduce_events(events, top: int = 12) -> dict:
    """``events``: (name, start_ns, duration_ns). Returns busy time (the
    union of the intervals) and the ``top`` names by total time."""
    total = defaultdict(float)
    calls = defaultdict(int)
    spans = []
    for name, start, dur in events:
        total[name] += dur
        calls[name] += 1
        spans.append((start, start + dur))
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    ranked = sorted(total, key=total.get, reverse=True)[:top]
    return {"busy_ms": busy / 1e6,
            "top": [[n, calls[n], total[n] / 1e6] for n in ranked]}


def device_events(xplane_path: str, plane_prefix: str = "/device:GPU"):
    """(``hlo_module:hlo_op``, start_ns, duration_ns) of every op on the
    planes whose name starts with ``plane_prefix``. Where a plane has an
    ``XLA Ops`` line, only that line is read (its stream lines repeat
    the same work as kernels)."""
    from jax.profiler import ProfileData
    out = []
    for plane in ProfileData.from_file(xplane_path).planes:
        if not plane.name.startswith(plane_prefix):
            continue
        lines = list(plane.lines)
        if any(line.name == "XLA Ops" for line in lines):
            lines = [line for line in lines if line.name == "XLA Ops"]
        for line in lines:
            for ev in line.events:
                stats = dict(ev.stats)
                name = stats.get("hlo_op", ev.name)
                module = stats.get("hlo_module")
                if module:
                    name = f"{module}:{name}"
                out.append((name, ev.start_ns, ev.duration_ns))
    return out


def traced(fn, out_dir: str, tag: str, top: int) -> dict:
    """Trace one call of ``fn`` (already warmed up) and reduce it."""
    import jax
    path = os.path.join(out_dir, tag)
    jax.profiler.start_trace(path)
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    window = time.perf_counter() - t0
    jax.profiler.stop_trace()
    (pb,) = glob.glob(os.path.join(path, "**", "*.xplane.pb"),
                      recursive=True)
    rec = reduce_events(device_events(pb), top)
    rec["window_ms"] = window * 1e3
    rec["idle_share"] = 1.0 - rec["busy_ms"] / rec["window_ms"]
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scale", type=int, default=22)
    p.add_argument("--top", type=int, default=12)
    p.add_argument("--out", default=os.path.join("chiprun_out", "trace"))
    args = p.parse_args(argv)

    import jax

    import chip_smoke as cs
    import gunrock_jax as gt
    from gunrock_jax.models.bfs import _bfs_init, _pull_step
    from gunrock_jax.models.bc import bc_device
    from gunrock_jax.models.bfs import bfs_device
    from gunrock_jax.models.cc import cc_device
    from gunrock_jax.models.hits import hits_device
    from gunrock_jax.models.pr import pagerank_device
    from gunrock_jax.models.sssp import sssp_device
    from gunrock_jax.utils.runtime import (enable_compile_cache,
                                           gpu_name_and_power_limit)

    if jax.devices()[0].platform != "gpu":
        print(f"trace_ops: no GPU (JAX platform "
              f"{jax.devices()[0].platform!r})", file=sys.stderr)
        return 2
    enable_compile_cache()
    card = gpu_name_and_power_limit()
    g = cs.kron_graph(args.scale)
    dg = gt.to_device(g, with_csc=True, with_edge_values=True,
                      with_edge_src=True)
    root = cs.graph500_roots(g, 1, 1)[0]

    queries = {
        "bfs_do": lambda: bfs_device(dg, root, mark_preds=True,
                                     direction_optimized=True),
        "sssp": lambda: sssp_device(dg, root),
        "pagerank": lambda: pagerank_device(dg, threshold=0.0,
                                            max_iters=cs.PR_ITERS),
        "cc": lambda: cc_device(dg),
        "bc": lambda: bc_device(dg, root),
        "hits": lambda: hits_device(dg, max_iters=10),
    }
    for tag, fn in queries.items():
        jax.block_until_ready(fn())
        rec = {"query": f"{tag}_kron{args.scale}", "card": card,
               **traced(fn, args.out, tag, args.top)}
        if tag == "bfs_do":
            levels = gt.bfs(dg, root, direction_optimized=True,
                            instrumented=True).info["per_iteration"]
            n_pull = sum(r["phase"] == "pull" for r in levels)
            fcap = max(128, dg.v_pad // 4)
            state = _bfs_init(dg, jax.numpy.int32(root), fcap, True)
            pull = jax.jit(_pull_step, static_argnums=(1, 2))
            step = lambda: pull(dg, fcap, True, state)  # noqa: E731
            jax.block_until_ready(step())
            one = traced(step, args.out, "bfs_pull_step", args.top)
            rec.update(levels=len(levels), pull_levels=n_pull,
                       pull_step_ms=one["busy_ms"],
                       pull_share=n_pull * one["busy_ms"] / rec["busy_ms"])
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
