"""Command-line drivers — JAX rebuild of the reference's per-app test
binaries (``tests/*/test_*.cu``) and their shared flag surface
(``CommandLineArgs`` ``util/test_utils.h:98-139`` parsed into
``TestParameter_Base`` ``app/problem_base.cuh:1258-1393``).

Usage mirrors the reference drivers::

    python -m gunrock_jax bfs market graph.mtx --undirected \
        --src=largestdegree --mark-pred --direction-optimized
    python -m gunrock_jax sssp rmat --rmat_scale=16 --rmat_edgefactor=8
    python -m gunrock_jax pr market graph.mtx --max-iter=50 --jsondir=out/

Each run: load/generate the graph -> run the primitive ``--iteration-num``
times -> validate against the in-package CPU oracle (skipped by
``--quick``, reference semantics) -> print CORRECT/INCORRECT -> emit the
Info JSON run record (``util/info.cuh``) to ``--jsonfile/--jsondir``.
``--num-shards=N`` routes every primitive through its multi-chip
shard_map path (the reference's ``--device=0,1,...``; on one chip this
is the ``--device=0,0`` fake-multi-GPU trick, CMakeLists.txt:389-421).
The reference's multi-GPU zoo covers bfs/sssp/bc/cc/pr only; here the
link-analysis and counting primitives shard too.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .graph.csr import CsrGraph
from .io import generators, market
from .utils import reference as oracle
from .utils.info import write_info

__all__ = ["main", "build_parser", "load_graph_from_args"]

PRIMITIVES = ("bfs", "sssp", "pr", "pagerank", "cc", "bc", "hits",
              "salsa", "wtf", "topk", "tc")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gunrock_jax",
        description="graph analytics in JAX (Gunrock-parity CLI)")
    p.add_argument("primitive", choices=PRIMITIVES)
    p.add_argument("graph_type", nargs="?", default="rmat",
                   choices=("market", "rmat", "rgg", "smallworld", "binary"),
                   help="graph source (reference graph_type argv)")
    p.add_argument("graph_file", nargs="?", default=None,
                   help="path for market/binary graph types")

    g = p.add_argument_group("graph")
    g.add_argument("--undirected", action="store_true",
                   help="symmetrize edges (reference --undirected)")
    g.add_argument("--random-edge-values", action="store_true",
                   help="attach uniform random weights (market reader flag)")
    g.add_argument("--edge-value-seed", type=int, default=0)
    g.add_argument("--rmat_scale", type=int, default=10)
    g.add_argument("--rmat_edgefactor", type=float, default=16.0)
    g.add_argument("--rmat_a", type=float, default=0.57)
    g.add_argument("--rmat_b", type=float, default=0.19)
    g.add_argument("--rmat_c", type=float, default=0.19)
    g.add_argument("--rmat_seed", type=int, default=0)
    g.add_argument("--rgg_nodes", type=int, default=1 << 10)
    g.add_argument("--rgg_threshold", type=float, default=None)
    g.add_argument("--sw_nodes", type=int, default=1 << 10)
    g.add_argument("--sw_k", type=int, default=6)
    g.add_argument("--sw_p", type=float, default=0.1)
    g.add_argument("--no-cache", action="store_true",
                   help="skip the binary .csr cache when loading market")

    r = p.add_argument_group("run")
    r.add_argument("--src", default="0",
                   help="source vertex: int | largestdegree | randomize "
                        "(reference --src)")
    r.add_argument("--iteration-num", type=int, default=1,
                   help="number of timed runs (reference --iteration-num)")
    r.add_argument("--quick", action="store_true",
                   help="skip CPU reference validation (reference --quick)")
    r.add_argument("--instrumented", action="store_true",
                   help="collect per-iteration kernel records "
                        "(reference --instrumented; bfs/sssp/pr/bc/cc)")
    r.add_argument("--quiet", action="store_true")
    r.add_argument("--queue-sizing", type=float, default=1.0,
                   help="frontier capacity factor (reference --queue-sizing)")
    r.add_argument("--jsonfile", default=None)
    r.add_argument("--jsondir", default=None)
    r.add_argument("--seed", type=int, default=0)

    m = p.add_argument_group("multi-chip")
    m.add_argument("--num-shards", type=int, default=0,
                   help="shard across N mesh devices (reference --device "
                        "list; 0 = single chip)")
    m.add_argument("--partition-method", default="random",
                   choices=("random", "biasrandom", "cluster", "static",
                            "metis", "duplicate"))
    m.add_argument("--partition-seed", type=int, default=0)

    a = p.add_argument_group("primitive options")
    a.add_argument("--mark-pred", action="store_true",
                   help="BFS MARK_PREDECESSORS / SSSP MARK_PATHS")
    a.add_argument("--idempotence", action="store_true",
                   help="accepted for parity (no effect on results)")
    a.add_argument("--direction-optimized", action="store_true")
    a.add_argument("--do_a", type=float, default=15.0,
                   help="DO-BFS push->pull factor (reference do_a=0.001)")
    a.add_argument("--do_b", type=float, default=18.0,
                   help="DO-BFS pull->push factor (reference do_b=0.200)")
    a.add_argument("--traversal-mode", default="LB",
                   help="accepted for parity; the advance is always "
                        "merge-path load-balanced (LB/TWC/LB_CULL/...)")
    a.add_argument("--mode", default="bellman", choices=("bellman", "nearfar"),
                   help="SSSP strategy (near-far delta-stepping pile)")
    a.add_argument("--delta-factor", type=float, default=32.0,
                   help="SSSP near-far delta factor (reference gunrock.h:98)")
    a.add_argument("--max-iter", type=int, default=50,
                   help="PR/HITS/SALSA/WTF iteration cap")
    a.add_argument("--error", type=float, default=1e-6,
                   help="PR convergence threshold (reference --error)")
    a.add_argument("--normalized", action="store_true", default=True)
    a.add_argument("--top-nodes", type=int, default=10,
                   help="TopK / WTF result count")
    a.add_argument("--alpha", type=float, default=0.2,
                   help="WTF teleport parameter")
    return p


def load_graph_from_args(args) -> CsrGraph:
    if args.graph_type == "market":
        if not args.graph_file:
            raise SystemExit("market graph type needs a .mtx path")
        return market.load_market(
            args.graph_file,
            undirected=args.undirected or None,
            random_edge_values=args.random_edge_values,
            seed=args.edge_value_seed,
            use_cache=not args.no_cache)
    if args.graph_type == "binary":
        if not args.graph_file:
            raise SystemExit("binary graph type needs a .csr.npz path")
        return CsrGraph.read_binary(args.graph_file)
    if args.graph_type == "rmat":
        return generators.rmat(
            scale=args.rmat_scale, edge_factor=args.rmat_edgefactor,
            a=args.rmat_a, b=args.rmat_b, c=args.rmat_c,
            seed=args.rmat_seed, undirected=args.undirected or True,
            random_edge_values=args.random_edge_values)
    if args.graph_type == "rgg":
        return generators.rgg(args.rgg_nodes, args.rgg_threshold,
                              seed=args.seed)
    if args.graph_type == "smallworld":
        return generators.small_world(args.sw_nodes, args.sw_k, args.sw_p,
                                      seed=args.seed)
    raise SystemExit(f"unknown graph type {args.graph_type}")


def _resolve_src(args, g: CsrGraph, rng) -> int:
    if args.src == "largestdegree":
        return g.largest_degree_vertex()
    if args.src == "randomize":
        return int(rng.integers(0, g.num_nodes))
    return int(args.src)


def _report(ok: bool, label: str, quiet: bool) -> bool:
    if not quiet:
        print(f"{label} validation: {'CORRECT' if ok else 'INCORRECT'}")
    return ok


def _run_bfs(args, g, src):
    if args.num_shards:
        from .parallel.bfs import bfs_sharded
        res = bfs_sharded(g, src, num_shards=args.num_shards,
                          partition_method=args.partition_method,
                          seed=args.partition_seed,
                          mark_preds=args.mark_pred)
    else:
        from .models import bfs
        res = bfs(g, src, mark_preds=args.mark_pred,
                  direction_optimized=args.direction_optimized,
                  alpha=args.do_a, beta=args.do_b,
                  queue_sizing=args.queue_sizing,
                  idempotence=args.idempotence,
                  instrumented=args.instrumented)
    ok = True
    if not args.quick:
        ok = _report(bool(np.array_equal(res.labels, oracle.cpu_bfs(g, src))),
                     "bfs", args.quiet)
    return res.info, ok


def _run_sssp(args, g, src):
    if g.edge_values is None:
        g.random_edge_values(seed=args.edge_value_seed)
    if args.num_shards:
        from .parallel.sssp import sssp_sharded
        res = sssp_sharded(g, src, num_shards=args.num_shards,
                           partition_method=args.partition_method,
                           seed=args.partition_seed, mode=args.mode,
                           delta_factor=args.delta_factor)
    else:
        from .models import sssp
        res = sssp(g, src, mark_preds=args.mark_pred, mode=args.mode,
                   delta_factor=args.delta_factor,
                   queue_sizing=args.queue_sizing,
                   instrumented=args.instrumented)
    ok = True
    if not args.quick:
        ref = oracle.cpu_sssp(g, src)
        got = np.where(np.isfinite(res.distances), res.distances, np.inf)
        ok = _report(bool(np.allclose(got, ref, rtol=1e-4, atol=1e-4)),
                     "sssp", args.quiet)
    return res.info, ok


def _run_pr(args, g, src):
    if args.num_shards:
        from .parallel.pr import pagerank_sharded
        res = pagerank_sharded(g, num_shards=args.num_shards,
                               partition_method=args.partition_method,
                               seed=args.partition_seed,
                               damping=0.85, max_iters=args.max_iter)
    else:
        from .models import pagerank
        res = pagerank(g, damping=0.85, threshold=args.error,
                       max_iters=args.max_iter, normalized=args.normalized,
                       instrumented=args.instrumented)
    ok = True
    if not args.quick:
        ref = oracle.cpu_pagerank(g, 0.85, args.max_iter, args.error,
                                  normalized=args.normalized)
        ok = _report(bool(np.allclose(res.ranks, ref, rtol=2e-2, atol=1e-5)),
                     "pr", args.quiet)
    return res.info, ok


def _run_cc(args, g, src):
    if args.num_shards:
        from .parallel.cc import cc_sharded
        res = cc_sharded(g, num_shards=args.num_shards,
                         partition_method=args.partition_method,
                         seed=args.partition_seed)
    else:
        from .models import cc
        res = cc(g, instrumented=args.instrumented)
    ok = True
    if not args.quick:
        ref = oracle.cpu_cc(g)
        # Component ids are representative-relabeled; compare partitions.
        same = (res.components[g.edge_sources()] ==
                res.components[g.col_indices]).all()
        n_ref = len(np.unique(ref))
        ok = _report(bool(same and res.num_components == n_ref),
                     "cc", args.quiet)
    return res.info, ok


def _run_bc(args, g, src):
    if args.num_shards:
        from .parallel.bc import bc_sharded
        res = bc_sharded(g, src, num_shards=args.num_shards,
                         partition_method=args.partition_method,
                         seed=args.partition_seed)
    else:
        from .models import bc
        res = bc(g, src, queue_sizing=args.queue_sizing,
                 instrumented=args.instrumented)
    ok = True
    if not args.quick:
        ref = oracle.cpu_bc(g, src)
        ok = _report(bool(np.allclose(res.bc_values, ref, rtol=1e-3,
                                      atol=1e-3)), "bc", args.quiet)
    return res.info, ok


def _run_hits(args, g, src):
    if args.num_shards:
        from .parallel.hits import hits_sharded
        res = hits_sharded(g, max_iters=args.max_iter,
                           num_shards=args.num_shards,
                           partition_method=args.partition_method,
                           seed=args.partition_seed)
    else:
        from .models import hits
        res = hits(g, max_iters=args.max_iter)
    ok = True
    if not args.quick:
        hub, auth = oracle.cpu_hits(g, args.max_iter)
        ok = _report(bool(np.allclose(res.hubs, hub, rtol=1e-3, atol=1e-4)
                          and np.allclose(res.auths, auth, rtol=1e-3,
                                          atol=1e-4)), "hits", args.quiet)
    return res.info, ok


def _run_salsa(args, g, src):
    if args.num_shards:
        from .parallel.hits import salsa_sharded
        res = salsa_sharded(g, max_iters=args.max_iter,
                            num_shards=args.num_shards,
                            partition_method=args.partition_method,
                            seed=args.partition_seed)
    else:
        from .models import salsa
        res = salsa(g, max_iters=args.max_iter)
    ok = True
    if not args.quick:
        hub, auth = oracle.cpu_salsa(g, args.max_iter)
        ok = _report(bool(np.allclose(res.hubs, hub, rtol=1e-3, atol=1e-5)
                          and np.allclose(res.auths, auth, rtol=1e-3,
                                          atol=1e-5)), "salsa", args.quiet)
    return res.info, ok


def _run_wtf(args, g, src):
    if args.num_shards:
        from .parallel.wtf import wtf_sharded
        res = wtf_sharded(g, src, alpha=args.alpha,
                          max_iters=args.max_iter,
                          num_shards=args.num_shards,
                          partition_method=args.partition_method,
                          seed=args.partition_seed)
    else:
        from .models import wtf
        res = wtf(g, src, alpha=args.alpha, max_iters=args.max_iter)
    ok = True
    if not args.quick:
        ref, ppr = oracle.cpu_wtf(g, src, alpha=args.alpha,
                                  max_iters=args.max_iter)
        # Compare the top-k score VALUES (tie ordering may differ) and
        # the phase-1 PPR vector.
        k = res.scores.shape[0]
        ref_top = np.sort(ref)[::-1][:k]
        ok = _report(bool(
            np.allclose(res.ppr_ranks, ppr, rtol=1e-3, atol=1e-6)
            and np.allclose(np.sort(res.scores)[::-1], ref_top,
                            rtol=1e-3, atol=1e-6)),
            "wtf", args.quiet)
    return res.info, ok


def _run_topk(args, g, src):
    if args.num_shards:
        from .parallel.topk import topk_sharded
        res = topk_sharded(g, k=args.top_nodes,
                           num_shards=args.num_shards,
                           partition_method=args.partition_method,
                           seed=args.partition_seed)
    else:
        from .models import topk
        res = topk(g, k=args.top_nodes)
    ok = True
    if not args.quick:
        gc = g.csc()
        cent = g.out_degrees + gc.out_degrees
        ref = np.sort(cent)[::-1][: args.top_nodes]
        ok = _report(
            bool(np.array_equal(np.sort(res.centralities)[::-1], ref)),
            "topk", args.quiet)
    return res.info, ok


def _run_tc(args, g, src):
    if args.num_shards:
        from .parallel.tc import tc_sharded
        res = tc_sharded(g, num_shards=args.num_shards)
    else:
        from .models.tc import tc as tc_fn
        res = tc_fn(g)
    ok = True
    if not args.quick:
        ok = _report(res.total == oracle.cpu_tc(g), "tc", args.quiet)
    return res.info, ok


_RUNNERS = {
    "bfs": _run_bfs, "sssp": _run_sssp, "pr": _run_pr, "pagerank": _run_pr,
    "cc": _run_cc, "bc": _run_bc, "hits": _run_hits, "salsa": _run_salsa,
    "wtf": _run_wtf, "topk": _run_topk, "tc": _run_tc,
}


def main(argv=None) -> int:
    from .utils.runtime import enable_compile_cache
    args = build_parser().parse_args(argv)
    enable_compile_cache()
    rng = np.random.default_rng(args.seed)
    g = load_graph_from_args(args)
    if not args.quiet:
        print(f"graph: |V|={g.num_nodes} |E|={g.num_edges} "
              f"({args.graph_type})")

    runner = _RUNNERS[args.primitive]
    all_ok, info = True, {}
    for it in range(max(1, args.iteration_num)):
        src = _resolve_src(args, g, rng)
        info, ok = runner(args, g, src)
        all_ok &= ok
        if not args.quiet:
            mteps = info.get("m_teps")
            print(f"run {it}: process {info.get('process_ms', 0.0):.3f} ms"
                  + (f", {mteps:.1f} MTEPS" if mteps else "")
                  + (f", depth {info['search_depth']}"
                     if "search_depth" in info else ""))
            if args.instrumented and info.get("phase_ms"):
                # per-kernel duty split (reference --instrumented
                # avg_duty, util/info.cuh:1380-1385)
                split = ", ".join(
                    f"{k} {v:.1f} ms/{info['phase_iterations'][k]} it"
                    for k, v in sorted(info["phase_ms"].items()))
                duty = info.get("avg_duty")
                print(f"  phases: {split}"
                      + (f"; avg_duty {duty:.2f}" if duty else ""))

    path = write_info(info, args.jsonfile, args.jsondir)
    if path and not args.quiet:
        print(f"json: {path}")
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
