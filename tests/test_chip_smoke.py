"""``chip_smoke.py`` rehearsed on CPU: its phases at tiny size, its
checkers against corrupted answers, and its refusal to run without a
GPU. Also the compile-cache rule every entry point shares."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs
import gunrock_jax as gt
from gunrock_jax.utils import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_phase_kron_small_scale():
    rec = cs.phase_kron(scale=9)
    assert rec["phase"] == "kron9" and len(rec["roots"]) == cs.ROOTS
    assert set(rec["times_s"]) == {"bfs_do", "sssp", "pagerank", "cc"}


def test_phase_grid_small_side():
    rec = cs.phase_grid(side=24)
    assert rec["bfs_depth"] == 2 * 23


def test_phase_small_small_scale():
    rec = cs.phase_small(scale=8)
    assert {"bc", "hits", "salsa", "wtf", "topk", "tc",
            "cli_bfs"} == set(rec["times_s"])


def test_phase_four_on_four_cpu_devices():
    rec = cs.phase_four(scale=9, shards=4)
    assert rec["shards"] == 4
    assert set(rec["comm_bytes"]) == {"bfs", "sssp", "pagerank", "cc"}
    assert rec["comm_bytes"]["bfs"] > 0


@pytest.fixture(scope="module")
def answers():
    """A small graph with correct answers to corrupt."""
    g = cs.kron_graph(8, seed=4)
    root = cs.graph500_roots(g, 1, seed=1)[0]
    dg = gt.to_device(g, with_csc=True, with_edge_values=True,
                      with_edge_src=True)
    bfs = gt.bfs(dg, root, mark_preds=True, direction_optimized=True)
    return {"g": g, "root": root, "labels": bfs.labels, "preds": bfs.preds,
            "dist": gt.sssp(dg, root).distances,
            "ranks": gt.pagerank(dg, threshold=0.0,
                                 max_iters=cs.PR_ITERS).ranks,
            "comp": gt.cc(dg).components}


def _corrupt(a, kind):
    g, root = a["g"], a["root"]
    labels, preds = a["labels"].copy(), a["preds"].copy()
    deep = int(np.flatnonzero(labels == labels.max())[0])
    if kind == "bfs_label":
        labels[deep] += 1
        return lambda: cs.check_bfs(g, root, labels, preds)
    if kind == "bfs_pred_level":
        preds[deep] = deep
        return lambda: cs.check_bfs(g, root, labels, preds)
    if kind == "bfs_pred_not_edge":
        # a vertex one level up that is not a neighbour
        nbrs = set(g.col_indices[g.row_offsets[deep]:
                                 g.row_offsets[deep + 1]].tolist())
        up = [int(v) for v in np.flatnonzero(labels == labels[deep] - 1)
              if int(v) not in nbrs]
        preds[deep] = up[0]
        return lambda: cs.check_bfs(g, root, labels, preds)
    if kind == "bfs_pred_on_source":
        preds[root] = deep
        return lambda: cs.check_bfs(g, root, labels, preds)
    if kind == "sssp_distance":
        dist = a["dist"].copy()
        dist[deep] *= 1.001
        return lambda: cs.check_sssp(g, root, dist)
    if kind == "sssp_reach":
        dist = a["dist"].copy()
        dist[deep] = np.inf
        return lambda: cs.check_sssp(g, root, dist)
    if kind == "pagerank":
        ranks = a["ranks"].copy()
        ranks[root] += 2 * cs.PR_L1
        return lambda: cs.check_pr(g, ranks, cs.PR_ITERS)
    if kind == "cc_merge":
        comp = a["comp"].copy()
        comp[comp == comp.max()] = 0
        return lambda: cs.check_cc(g, comp)
    raise AssertionError(kind)


def test_checkers_accept_correct_answers(answers):
    a = answers
    cs.check_bfs(a["g"], a["root"], a["labels"], a["preds"])
    cs.check_sssp(a["g"], a["root"], a["dist"])
    cs.check_pr(a["g"], a["ranks"], cs.PR_ITERS)
    cs.check_cc(a["g"], a["comp"])
    cs.check_rel("same", a["ranks"], a["ranks"])


@pytest.mark.parametrize("kind", [
    "bfs_label", "bfs_pred_level", "bfs_pred_not_edge", "bfs_pred_on_source",
    "sssp_distance", "sssp_reach", "pagerank", "cc_merge"])
def test_checkers_reject_corrupted_answers(answers, kind):
    with pytest.raises(cs.CheckFailed):
        _corrupt(answers, kind)()


@pytest.mark.parametrize("got, expect", [
    ([1.0, 2.0], [1.0, 2.001]),
    # 1% off in a small entry: each element is held to its own size
    ([1.0, 1.01e-3], [1.0, 1e-3]),
])
def test_check_rel_rejects_drift(got, expect):
    with pytest.raises(cs.CheckFailed):
        cs.check_rel("x", np.array(got), np.array(expect))


def test_check_rel_accepts_f32_underflow():
    # the f64 oracle keeps entries far below f32's range; f32 gives 0
    cs.check_rel("x", np.array([0.5, 0.0]), np.array([0.5, 1e-240]))


def test_main_refuses_cpu(capsys):
    assert cs.main([]) != 0
    assert cs.main(["--four"]) != 0
    assert '"ok"' not in capsys.readouterr().out


def _no_ok_line(proc):
    return proc.returncode != 0 and '"ok"' not in proc.stdout


def test_script_refuses_cpu_platform():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       env=env, capture_output=True, text=True,
                       timeout=300)
    assert _no_ok_line(p), p.stdout


def test_script_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True,
                       timeout=300)
    assert _no_ok_line(p), p.stdout


def test_import_takes_no_device():
    """Importing the package or the script starts no backend: a process
    that only imports them (a worker, ``--help``) must not reserve the
    card's memory."""
    code = ("import jax._src.xla_bridge as xb, chip_smoke, gunrock_jax;"
            "assert not xb._backends, list(xb._backends)")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_rule(monkeypatch, tmp_path, env_set):
    import jax
    before = jax.config.jax_compilation_cache_dir
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        expect = str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        expect = os.path.join(REPO, ".jax_cache")
    try:
        assert runtime.compile_cache_dir() == expect
        assert runtime.enable_compile_cache() == expect
        if env_set:   # JAX reads the variable itself; nothing overridden
            assert jax.config.jax_compilation_cache_dir == before
        else:
            assert jax.config.jax_compilation_cache_dir == expect
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_device_record_names_the_platform():
    rec = runtime.device_record()
    assert rec["platform"] == "cpu" and rec["device_count"] >= 1
    assert "device_kind" in rec and "gpu" in rec
    line = json.dumps(rec)
    assert "cpu" in line
