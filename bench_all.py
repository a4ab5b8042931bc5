"""Full benchmark table: every headline primitive on the bench graph.

Prints one JSON line per primitive (bench.py remains the single-line
flagship driver); each names the device it ran on. Methodology matches
the reference (process time only, m_teps = edges_visited/(elapsed_ms*
1000), util/info.cuh:1431). Refuses to run without a GPU, and exits
non-zero when any row fails.

  BENCH_SCALE=20 BENCH_EDGE_FACTOR=32 python bench_all.py

Graph-matrix mode (the reference's per-graph engine table,
``doc/stats/engines_topc.md`` / ``dataset/test-scripts/ipdps17``):
``BENCH_GRAPH`` selects the dataset —

  BENCH_GRAPH=rmat:22:64 python bench_all.py     # rmat_n22_e64 row
  BENCH_GRAPH=rgg:24 python bench_all.py         # rgg_n24 row
  BENCH_GRAPH=grid:1448 python bench_all.py      # road-like row
  BENCH_GRAPH=market:graph.mtx python bench_all.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SCALE = int(os.environ.get("BENCH_SCALE", "20"))
EF = int(os.environ.get("BENCH_EDGE_FACTOR", "32"))
RUNS = int(os.environ.get("BENCH_RUNS", "3"))
ONLY = os.environ.get("BENCH_ONLY", "").split(",") if \
    os.environ.get("BENCH_ONLY") else None
GRAPH = os.environ.get("BENCH_GRAPH", f"rmat:{SCALE}:{EF}")


def load_graph(cdir):
    """Build/load the BENCH_GRAPH dataset; returns (graph, tag, kind)."""
    import gunrock_jax as gt
    import numpy as np
    parts = GRAPH.split(":")
    kind = parts[0]
    os.makedirs(cdir, exist_ok=True)
    if kind == "rmat":
        scale, ef = int(parts[1]), int(parts[2])
        tag = f"rmat{scale}" if (scale, ef) == (SCALE, EF) \
            else f"rmat{scale}e{ef}"
        cache = os.path.join(cdir, f"rmat_n{scale}_e{ef}.csr.npz")
        if os.path.exists(cache):
            return gt.CsrGraph.read_binary(cache), tag, kind
        g = gt.io.rmat(scale=scale, edge_factor=ef, seed=1,
                       undirected=True)
        g.write_binary(cache)
        return g, tag, kind
    if kind == "rgg":
        scale = int(parts[1])
        cache = os.path.join(cdir, f"rgg_n{scale}.csr.npz")
        if os.path.exists(cache):
            return gt.CsrGraph.read_binary(cache), f"rgg{scale}", kind
        g = gt.io.generators.rgg(1 << scale, seed=1)
        g.write_binary(cache)
        return g, f"rgg{scale}", kind
    if kind == "grid":
        n = int(parts[1])
        idx = np.arange(n * n).reshape(n, n)
        gsrc = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
        gdst = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
        return gt.from_coo(n * n, gsrc, gdst, undirected=True), \
            f"grid{n}", kind
    if kind == "market":
        path = ":".join(parts[1:])
        if not path:
            raise SystemExit("BENCH_GRAPH=market:<path to .mtx>")
        g = gt.io.load_market(path, undirected=True, use_cache=False)
        tag = os.path.splitext(os.path.basename(path))[0]
        return g, tag, kind
    raise SystemExit(f"unknown BENCH_GRAPH {GRAPH!r}")


def best_ms(fn, runs=RUNS):
    import jax
    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


DEVICE = {}


def emit(name, ms, edges, extra=None, primitive=None, graph_kind=None):
    rec = {"metric": name, "elapsed_ms": ms,
           "value": edges / (ms * 1000.0), "unit": "MTEPS",
           "edges_counted": int(edges), **DEVICE}
    if extra:
        rec.update(extra)
    if primitive is not None:
        from gunrock_jax.utils.baseline import annotate
        annotate(rec, primitive, graph_kind or "rmat", rec["value"])
    print(json.dumps(rec), flush=True)


def main():
    import traceback

    import jax
    import numpy as np
    import gunrock_jax as gt
    from gunrock_jax.utils.runtime import device_record, enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"bench_all.py measures a GPU; found "
                         f"{jax.devices()[0].platform}")
    enable_compile_cache()
    DEVICE.update(device_record())
    cdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        ".bench_cache")
    g, tag, kind = load_graph(cdir)
    src = g.largest_degree_vertex()
    E = g.num_edges
    degs = np.diff(g.row_offsets).astype(np.int64)
    # Scale-free graphs take DO + bellman; mesh-like (grid/rgg) take
    # non-DO + near-far — the reference's per-graph tuned knobs
    # (dataset/test-scripts/ipdps17/run_fig2.sh: --direction-optimized
    # and --delta-factor per dataset).
    meshy = kind in ("grid", "rgg")

    def want(name):
        return ONLY is None or name in ONLY

    def row_bfs():
        from gunrock_jax.models.bfs import bfs_device
        dg = gt.to_device(g, with_csc=not meshy)
        out = jax.block_until_ready(
            bfs_device(dg, src, direction_optimized=not meshy,
                       max_iters=16384))
        reached = np.asarray(out[0])[: g.num_nodes] >= 0
        ev = int(degs[reached].sum())
        ms = best_ms(lambda: bfs_device(dg, src,
                                        direction_optimized=not meshy,
                                        max_iters=16384))
        emit(f"bfs_do_{tag}" if not meshy else f"bfs_{tag}", ms, ev,
             {"search_depth": int(np.asarray(out[0]).max())},
             primitive="bfs", graph_kind=kind)

    def row_sssp():
        from gunrock_jax.models.sssp import sssp_device
        g.random_edge_values(seed=7)
        dgw = gt.to_device(g, with_edge_values=True)
        mode = "nearfar" if meshy else "bellman"
        # Per-graph tuned delta-factor (the reference does the same,
        # dataset/test-scripts/ipdps17/run_fig2.sh): meshy graphs take a
        # small delta so the near bucket stays inside the micro-queue
        # rung.
        delta = (8.0 if meshy else 32.0) * float(np.mean(g.edge_values))
        out = jax.block_until_ready(
            sssp_device(dgw, src, mode=mode, delta=delta))
        reached = np.isfinite(np.asarray(out[0])[: g.num_nodes])
        ev = int(degs[reached].sum())
        ms = best_ms(lambda: sssp_device(dgw, src, mode=mode,
                                         delta=delta))
        emit(f"sssp_{tag}", ms, ev,
             {"iters": int(out[2].iteration), "mode": mode},
             primitive="sssp", graph_kind=kind)

    def row_pr():
        from gunrock_jax.models.pr import pagerank_device
        dgc = gt.to_device(g, with_csc=True, with_edge_src=True)
        out = jax.block_until_ready(pagerank_device(dgc, max_iters=20,
                                                    threshold=0.0))
        iters = int(out[2].iteration)
        ms = best_ms(lambda: pagerank_device(dgc, max_iters=20,
                                             threshold=0.0))
        emit(f"pr_{tag}", ms / iters, E,
             {"note": "per-iteration", "iters": iters},
             primitive="pr", graph_kind=kind)

    def row_hits():
        from gunrock_jax.models.hits import hits_device
        dgc = gt.to_device(g, with_csc=True, with_edge_src=True)
        ms = best_ms(lambda: hits_device(dgc, max_iters=10))
        emit(f"hits_{tag}", ms / 10, 2 * E, {"note": "per-iteration"})

    def row_cc():
        from gunrock_jax.models.cc import cc_device
        dge = gt.to_device(g, with_edge_src=True)
        out = jax.block_until_ready(cc_device(dge))
        ms = best_ms(lambda: cc_device(dge))
        emit(f"cc_{tag}", ms, E, {"iters": int(out[2].iteration)},
             primitive="cc", graph_kind=kind)

    def row_bc():
        from gunrock_jax.models.bc import bc_device
        dgb = gt.to_device(g)
        ms = best_ms(lambda: bc_device(dgb, src))
        emit(f"bc_{tag}", ms, 2 * E, primitive="bc", graph_kind=kind)

    def row_deep():
        # Deep/high-diameter regime (road-like): non-DO BFS over a grid —
        # exercises the rung ladder and the deep micro-loop.
        from gunrock_jax.models.bfs import bfs_device
        n = 1024
        idx = np.arange(n * n).reshape(n, n)
        gsrc = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
        gdst = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
        gg = gt.from_coo(n * n, gsrc, gdst, undirected=True)
        dgg = gt.to_device(gg)
        out = jax.block_until_ready(bfs_device(dgg, 0))
        depth = int(np.asarray(out[0]).max())
        ms = best_ms(lambda: bfs_device(dgg, 0))
        emit("bfs_deep_grid1024", ms, gg.num_edges,
             {"search_depth": depth}, primitive="bfs", graph_kind="grid")
        del dgg

        # SSSP near-far on the same road-like graph (reference road_usa
        # SSSP row: 5.2 MTEPS on K40c, doc/stats/engines_topc.md).
        from gunrock_jax.models.sssp import sssp_device
        gg.random_edge_values(seed=1)
        dgw = gt.to_device(gg, with_edge_values=True)
        # near-far micro-queue, delta tuned per graph like the
        # reference's --delta-factor (ipdps17/run_fig2.sh).
        out = jax.block_until_ready(
            sssp_device(dgw, 0, mode="nearfar", delta=256.0))
        ms = best_ms(lambda: sssp_device(dgw, 0, mode="nearfar",
                                         delta=256.0))
        emit("sssp_deep_grid1024", ms, gg.num_edges,
             {"mode": "nearfar", "iters": int(out[2].iteration)},
             primitive="sssp", graph_kind="grid")

    def row_tc():
        # TC wedge volume on hub-heavy rmat grows superlinearly; the TC
        # row uses a smaller standard graph (reference TC benches do the
        # same, doc/stats: coAuthors/road-class graphs).
        from gunrock_jax.models.tc import tc
        gt_small = gt.io.rmat(scale=17, edge_factor=8, seed=1,
                              undirected=True)
        res = tc(gt_small)
        emit("tc_rmat17", res.info["process_ms"],
             res.info["wedges_probed"],
             {"triangles": res.total})

    def row_duty():
        # Per-kernel duty splits (reference avg_duty + kernel lifetimes,
        # util/kernel_runtime_stats.cuh, info.cuh:1380-1385): rerun each
        # instrumentable primitive through the result tier with
        # per-iteration phase records and emit the duty JSON.
        g.random_edge_values(seed=7)
        runs = [
            ("bfs", lambda: gt.bfs(g, src=src,
                                   direction_optimized=not meshy,
                                   instrumented=True)),
            ("sssp", lambda: gt.sssp(
                g, src=src, mode="nearfar" if meshy else "bellman",
                instrumented=True)),
            ("pr", lambda: gt.pagerank(g, max_iters=10, threshold=0.0,
                                       instrumented=True)),
            ("cc", lambda: gt.cc(g, instrumented=True)),
            ("bc", lambda: gt.bc(g, src=src, instrumented=True)),
        ]
        for pname, fn in runs:
            try:
                res = fn()
                rec = {"metric": f"duty_{pname}_{tag}",
                       "avg_duty": res.info.get("avg_duty"),
                       "phase_ms": res.info.get("phase_ms"),
                       "phase_iterations": res.info.get(
                           "phase_iterations"),
                       "process_ms": res.info.get("process_ms")}
                print(json.dumps(rec), flush=True)
            except Exception:
                print(f"# duty_{pname}_{tag} FAILED", file=sys.stderr)
                traceback.print_exc()
                failed.append(f"duty_{pname}")

    # Fault-isolated rows: one row failing (e.g. out of memory on a big
    # graph) does not stop the sweep, but the script then exits non-zero.
    failed = []
    rows = [("bfs", row_bfs), ("sssp", row_sssp),
            ("pr", row_pr), ("hits", row_hits), ("cc", row_cc),
            ("bc", row_bc), ("deep", row_deep), ("tc", row_tc)]
    if os.environ.get("BENCH_DUTY"):
        rows.append(("duty", row_duty))
    for name, fn in rows:
        if not want(name):
            continue
        try:
            fn()
        except Exception:
            print(f"# {name}_{tag} row FAILED", file=sys.stderr)
            traceback.print_exc()
            failed.append(name)
    if failed:
        raise SystemExit(f"failed rows: {', '.join(failed)}")


if __name__ == "__main__":
    main()
