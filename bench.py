"""Flagship benchmark: direction-optimized BFS on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "MTEPS", "platform": ..., ...}

Flagship: direction-optimized BFS MTEPS on a scale-free R-MAT graph
(the reference's headline BFS numbers are DO-BFS on soc-orkut / rmat
graphs, doc/stats/engines_topc.md).

Methodology matches the reference (doc/results.md:28-35): process time
excludes graph load/build/upload; m_teps = edges_visited/(elapsed_ms*1000)
(util/info.cuh:1431). Reported value = best of N timed runs after warmup
(compile cached). Refuses to run without a GPU.

  BENCH_SCALE=20 BENCH_EDGE_FACTOR=32 python bench.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SCALE = int(os.environ.get("BENCH_SCALE", "20"))
EDGE_FACTOR = int(os.environ.get("BENCH_EDGE_FACTOR", "32"))
RUNS = int(os.environ.get("BENCH_RUNS", "5"))
CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         ".bench_cache")


def load_graph():
    import gunrock_jax as gt

    os.makedirs(CACHE_DIR, exist_ok=True)
    cache = os.path.join(CACHE_DIR, f"rmat_n{SCALE}_e{EDGE_FACTOR}.csr.npz")
    if os.path.exists(cache):
        return gt.CsrGraph.read_binary(cache)
    g = gt.io.rmat(scale=SCALE, edge_factor=EDGE_FACTOR, seed=1,
                   undirected=True)
    try:
        g.write_binary(cache)
    except OSError:
        pass
    return g


def main():
    import jax
    import numpy as np

    import gunrock_jax as gt
    from gunrock_jax.models.bfs import bfs_device
    from gunrock_jax.utils.runtime import device_record, enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; found "
                         f"{jax.devices()[0].platform}")
    enable_compile_cache()
    g = load_graph()
    src = g.largest_degree_vertex()
    dgraph = gt.to_device(g, with_csc=True)

    # max_iters == chunk budget => single device call, no convergence
    # probe round-trip; the structural asserts below catch truncation.
    def run():
        return jax.block_until_ready(
            bfs_device(dgraph, src, direction_optimized=True,
                       max_iters=16384))

    labels, _, stats = run()  # warmup + compile
    lab = np.asarray(labels)[: g.num_nodes]
    reached = lab >= 0
    degs = np.diff(g.row_offsets).astype(np.int64)
    edges_visited = int(degs[reached].sum())

    # Structural correctness gate: BFS labels must satisfy the edge
    # relaxation property |l(u)-l(v)| <= 1 on reached edges, src label 0.
    assert lab[src] == 0, "src label wrong"
    rng = np.random.default_rng(0)
    probe = rng.integers(0, g.num_edges, 200_000)
    es = g.edge_sources()[probe]
    ed = g.col_indices[probe]
    both = (lab[es] >= 0) & (lab[ed] >= 0)
    assert (np.abs(lab[es][both].astype(np.int64) -
                   lab[ed][both].astype(np.int64)) <= 1).all(), \
        "BFS label property violated"
    assert not (reached[es] & ~reached[ed]).any(), \
        "reached vertex with unreached neighbor"

    best = float("inf")
    for _ in range(RUNS):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)

    elapsed_ms = best * 1000.0
    mteps = edges_visited / (elapsed_ms * 1000.0)
    rec = {
        "metric": f"bfs_do_mteps_rmat_n{SCALE}_e{EDGE_FACTOR}",
        "value": mteps,
        "unit": "MTEPS",
        "elapsed_ms": elapsed_ms,
        "edges_visited": edges_visited,
        "search_depth": int(np.asarray(labels).max()),
        "num_vertices": g.num_nodes,
        "num_edges": g.num_edges,
        **device_record(),
    }
    from gunrock_jax.utils.baseline import annotate
    annotate(rec, "bfs", "rmat", mteps)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
