"""Smoke run of the main path on one GPU, at a size users run.

Loads a Graph500 Kronecker graph once, answers BFS / SSSP / PageRank /
CC queries against it through the public entry points (``gt.to_device``,
``gt.bfs``, ...), and checks every answer against the CPU oracles in
``gunrock_jax.utils.reference``. Phases:

  kron22    Kronecker scale 22 (``--scale``), edge factor 16: DO-BFS with
            predecessors from 4 random roots of degree >= 1 (the Graph500
            rule), SSSP, PageRank, CC on one uploaded graph
  grid1024  1024 x 1024 grid (high diameter): BFS and near-far SSSP
  small     Kronecker scale 14: BC, HITS, SALSA, WTF, TopK, TC against
            the pure-Python oracles, and one in-process CLI run

``--four`` runs only the sharded path (``bfs/sssp/pagerank/cc_sharded``
over four devices) on the scale-22 graph, against the same oracles.

Each phase prints one line with its checks, first and second call times
and peak device memory. The last line is one JSON object naming the
device. The script refuses to run (non-zero exit, no JSON line) when JAX
finds no GPU.

  python chip_smoke.py [--scale N] [--four]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import time

import numpy as np

import gunrock_jax as gt
from gunrock_jax.utils import reference as ref
from gunrock_jax.utils.runtime import (enable_compile_cache,
                                       gpu_name_and_power_limit)

EDGE_FACTOR = 16        # Graph500
ROOTS = 4
PR_ITERS = 20
SMALL_SCALE = 14
GRID_SIDE = 1024

# Tolerances, printed with each phase line. There are no matrix
# products on these paths, so TF32 plays no part.
SSSP_RTOL, SSSP_ATOL = 1e-5, 1e-6   # device sums f32, the oracle f64
PR_L1 = 1e-4                        # ranks sum to 1; f32 sum order varies
REL_TOL = 1e-4                      # BC, HITS, SALSA, WTF: per element
REL_FLOOR = 1e-9                    # ... plus this times max|ref|: f32
                                    # flushes entries the f64 oracle
                                    # drives to 1e-240 (HITS) to zero


class CheckFailed(AssertionError):
    pass


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


# --------------------------------------------------------------- graphs

def kron_graph(scale: int, seed: int = 1):
    """Graph500 Kronecker graph (a=0.57, b=c=0.19), symmetrised, with
    uniform random edge weights from the seed."""
    g = gt.io.rmat(scale=scale, edge_factor=EDGE_FACTOR, seed=seed,
                   undirected=True)
    g.random_edge_values(seed=seed)
    return g


def grid_graph(side: int, seed: int = 1):
    idx = np.arange(side * side).reshape(side, side)
    src = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    dst = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    g = gt.from_coo(side * side, src, dst, undirected=True)
    g.random_edge_values(seed=seed)
    return g


def graph500_roots(g, k: int, seed: int) -> list:
    """``k`` distinct random roots of degree >= 1."""
    cand = np.flatnonzero(np.diff(g.row_offsets) > 0)
    rng = np.random.default_rng(seed)
    return [int(v) for v in rng.choice(cand, size=min(k, cand.size),
                                       replace=False)]


# --------------------------------------------------------------- checks

def check_bfs(g, src: int, labels, preds=None) -> None:
    """Labels exact; predecessors valid (any writer may win a scatter,
    so preds are checked for validity, not equality)."""
    expect = ref.bfs_levels(g, src)
    _check(np.array_equal(labels, expect),
           f"bfs labels from {src}: {int((labels != expect).sum())} differ")
    if preds is None:
        return
    n = g.num_nodes
    inner = np.flatnonzero(labels > 0)
    _check(preds[src] == -1 and np.all(preds[labels < 0] == -1),
           "bfs preds set on source or unreached vertices")
    p = preds[inner].astype(np.int64)
    _check(np.all((p >= 0) & (p < n)), "bfs preds out of range")
    _check(np.all(labels[p] == labels[inner] - 1),
           "bfs pred not one level up")
    keys = g.edge_sources().astype(np.int64) * n + g.col_indices
    if np.any(np.diff(keys) < 0):
        keys = np.sort(keys)
    q = p * n + inner
    pos = np.minimum(np.searchsorted(keys, q), keys.size - 1)
    _check(np.all(keys[pos] == q), "bfs (pred, v) is not an edge")


def check_sssp(g, src: int, dist) -> None:
    expect = ref.sssp_dijkstra(g, src)
    reach = np.isfinite(expect)
    _check(np.array_equal(np.isfinite(dist), reach),
           f"sssp reachable set from {src} differs")
    err = np.abs(dist[reach].astype(np.float64) - expect[reach])
    _check(np.all(err <= SSSP_RTOL * expect[reach] + SSSP_ATOL),
           f"sssp from {src}: max error {err.max(initial=0.0)}")


def _min_label(comp) -> np.ndarray:
    comp = np.asarray(comp, np.int64)
    mins = np.full(comp.max(initial=0) + 1, comp.size, np.int64)
    np.minimum.at(mins, comp, np.arange(comp.size))
    return mins[comp]


def check_cc(g, comp) -> None:
    _check(np.array_equal(_min_label(comp), ref.cc_min_label(g)),
           "cc partition differs")


def check_pr(g, ranks, iters: int) -> None:
    expect = ref.cpu_pagerank(g, max_iters=iters, tol=0.0)
    l1 = float(np.abs(ranks.astype(np.float64) - expect).sum())
    _check(l1 <= PR_L1, f"pagerank L1 {l1}")


def check_rel(what: str, got, expect) -> None:
    got = np.asarray(got, np.float64)
    expect = np.asarray(expect, np.float64)
    _check(got.shape == expect.shape and np.all(np.isfinite(got)),
           f"{what}: shape or non-finite values")
    err = np.abs(got - expect)
    bound = REL_TOL * np.abs(expect) + REL_FLOOR * np.abs(expect).max(
        initial=0.0)
    _check(np.all(err <= bound),
           f"{what}: {int((err > bound).sum())} entries off by more than "
           f"{REL_TOL} relative (worst |d-d*| {err.max(initial=0.0)})")


# --------------------------------------------------------------- timing

def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _twice(times: dict, name: str, fn):
    """Run ``fn`` twice; record first (compile + run) and second call."""
    out, t1 = _timed(fn)
    out, t2 = _timed(fn)
    times[name] = (t1, t2)
    return out


# --------------------------------------------------------------- phases

def phase_kron(scale: int = 22, seed: int = 1) -> dict:
    (g, setup_s) = _timed(lambda: kron_graph(scale, seed))
    dg, upload_s = _timed(lambda: gt.to_device(
        g, with_csc=True, with_edge_values=True, with_edge_src=True))
    roots = graph500_roots(g, ROOTS, seed)
    times = {}
    bfs_s = []
    for r in roots:
        res, t = _timed(lambda: gt.bfs(dg, r, mark_preds=True,
                                       direction_optimized=True))
        bfs_s.append(t)
        check_bfs(g, r, res.labels, res.preds)
    times["bfs_do"] = (bfs_s[0], bfs_s[1] if len(bfs_s) > 1 else None)
    res = _twice(times, "sssp", lambda: gt.sssp(dg, roots[0]))
    check_sssp(g, roots[0], res.distances)
    res = _twice(times, "pagerank", lambda: gt.pagerank(
        dg, threshold=0.0, max_iters=PR_ITERS))
    check_pr(g, res.ranks, PR_ITERS)
    res = _twice(times, "cc", lambda: gt.cc(dg))
    check_cc(g, res.components)
    return {"phase": f"kron{scale}", "vertices": g.num_nodes,
            "edges": g.num_edges, "roots": roots,
            "graph_s": setup_s, "upload_s": upload_s, "times_s": times,
            "bfs_s_per_root": bfs_s, "peak_bytes_in_use": _peak_bytes(),
            "tolerances": _TOL_KRON}


def phase_grid(side: int = GRID_SIDE, seed: int = 1) -> dict:
    g = grid_graph(side, seed)
    dg = gt.to_device(g, with_edge_values=True)
    times = {}
    res = _twice(times, "bfs", lambda: gt.bfs(dg, 0, mark_preds=True))
    check_bfs(g, 0, res.labels, res.preds)
    depth = int(res.labels.max())
    res = _twice(times, "sssp_nearfar",
                 lambda: gt.sssp(dg, 0, mode="nearfar"))
    check_sssp(g, 0, res.distances)
    return {"phase": f"grid{side}", "vertices": g.num_nodes,
            "edges": g.num_edges, "bfs_depth": depth, "times_s": times,
            "peak_bytes_in_use": _peak_bytes(),
            "tolerances": {k: _TOL_KRON[k] for k in ("bfs_labels",
                                                     "bfs_preds", "sssp")}}


def phase_small(scale: int = SMALL_SCALE, seed: int = 1) -> dict:
    from gunrock_jax import cli
    g = kron_graph(scale, seed)
    root = graph500_roots(g, 1, seed)[0]
    times = {}
    res = _twice(times, "bc", lambda: gt.bc(g, root))
    check_rel("bc", res.bc_values, ref.cpu_bc(g, root))
    res = _twice(times, "hits", lambda: gt.hits(g))
    hub, auth = ref.cpu_hits(g)
    check_rel("hits hubs", res.hubs, hub)
    check_rel("hits auths", res.auths, auth)
    res = _twice(times, "salsa", lambda: gt.salsa(g))
    hub, auth = ref.cpu_salsa(g)
    check_rel("salsa hubs", res.hubs, hub)
    check_rel("salsa auths", res.auths, auth)
    res = _twice(times, "wtf", lambda: gt.wtf(g, root))
    score, ppr = ref.cpu_wtf(g, root)
    check_rel("wtf ppr", res.ppr_ranks, ppr)
    k = res.scores.shape[0]
    check_rel("wtf scores", np.sort(res.scores)[::-1],
              np.sort(score)[::-1][:k])
    res = _twice(times, "topk", lambda: gt.topk(g, k=16))
    cent = np.diff(g.row_offsets) + np.bincount(g.col_indices,
                                                minlength=g.num_nodes)
    _check(np.array_equal(np.sort(res.centralities)[::-1],
                          np.sort(cent)[::-1][:16])
           and np.array_equal(cent[res.node_ids], res.centralities),
           "topk differs")
    res = _twice(times, "tc", lambda: gt.tc(g))
    _check(res.total == ref.cpu_tc(g), "tc total differs")
    out = io.StringIO()
    argv = ["bfs", "rmat", f"--rmat_scale={scale}",
            f"--rmat_edgefactor={EDGE_FACTOR}", f"--rmat_seed={seed}",
            f"--src={root}", "--direction-optimized"]
    with contextlib.redirect_stdout(out):
        (rc, cli_s) = _timed(lambda: cli.main(argv))
    _check(rc == 0 and "bfs validation: CORRECT" in out.getvalue(),
           "cli bfs did not print CORRECT")
    times["cli_bfs"] = (cli_s, None)
    return {"phase": f"small{scale}", "vertices": g.num_nodes,
            "edges": g.num_edges, "times_s": times,
            "peak_bytes_in_use": _peak_bytes(),
            "tolerances": _TOL_SMALL}


def phase_four(scale: int = 22, seed: int = 1, shards: int = 4) -> dict:
    from gunrock_jax.parallel import (bfs_sharded, cc_sharded,
                                      pagerank_sharded, sssp_sharded)
    g = kron_graph(scale, seed)
    root = graph500_roots(g, 1, seed)[0]
    times, comm = {}, {}
    res, times["bfs_sharded"] = _timed(lambda: bfs_sharded(
        g, root, num_shards=shards, mark_preds=True,
        direction_optimized=True))
    check_bfs(g, root, res.labels, res.preds)
    comm["bfs"] = res.info["comm_bytes"]
    res, times["sssp_sharded"] = _timed(
        lambda: sssp_sharded(g, root, num_shards=shards))
    check_sssp(g, root, res.distances)
    comm["sssp"] = res.info["comm_bytes"]
    res, times["pagerank_sharded"] = _timed(lambda: pagerank_sharded(
        g, num_shards=shards, threshold=0.0, max_iters=PR_ITERS))
    check_pr(g, res.ranks, PR_ITERS)
    comm["pagerank"] = res.info["comm_bytes"]
    res, times["cc_sharded"] = _timed(
        lambda: cc_sharded(g, num_shards=shards))
    check_cc(g, res.components)
    comm["cc"] = (res.info["comm_bytes_per_superstep"]
                  * res.info["num_iterations"])
    return {"phase": f"four_kron{scale}", "shards": shards,
            "vertices": g.num_nodes, "edges": g.num_edges, "root": root,
            "times_s": times, "comm_bytes": comm,
            "peak_bytes_in_use": _peak_bytes(), "tolerances": _TOL_KRON}


_TOL_KRON = {
    "bfs_labels": "exact",
    "bfs_preds": "valid: one level up and an edge (any scatter writer "
                 "may win)",
    "cc": "same partition, ids normalised to the minimum vertex id",
    "sssp": f"same reachable set, |d-d*| <= {SSSP_RTOL}*d* + {SSSP_ATOL} "
            "(f32 device sums vs f64 oracle)",
    "pagerank": f"L1 <= {PR_L1} after {PR_ITERS} iterations (ranks sum "
                "to 1; f32 sum order varies)",
}
_TOL_SMALL = {
    "bc_hits_salsa_wtf": f"per element |d-d*| <= {REL_TOL}*|d*| + "
                         f"{REL_FLOOR}*max|d*| (f32 vs f64)",
    "topk_tc": "exact",
    "cli": "prints CORRECT",
}


# --------------------------------------------------------------- main

def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scale", type=int, default=22,
                   help="Kronecker scale of the kron phase (and --four)")
    p.add_argument("--four", action="store_true",
                   help="run only the sharded path on four devices")
    args = p.parse_args(argv)

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devs[0].platform!r})",
              file=sys.stderr)
        return 2
    count = 4 if args.four else 1
    if len(devs) < count:
        print(f"chip_smoke: needs {count} GPUs, found {len(devs)}",
              file=sys.stderr)
        return 2
    enable_compile_cache()
    card = gpu_name_and_power_limit()

    if args.four:
        phases = [lambda: phase_four(args.scale)]
    else:
        phases = [lambda: phase_kron(args.scale), phase_grid, phase_small]
    for run in phases:
        try:
            rec, total = _timed(run)
        except Exception as e:  # report the phase, then fail the run
            print(f"FAIL {type(e).__name__}: {e}", flush=True)
            raise
        rec["phase_s"] = total
        rec["card"] = card
        print("PASS " + json.dumps(rec), flush=True)

    print(f"gpu: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
