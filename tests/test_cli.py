"""CLI drivers (reference tests/*/test_*.cu equivalents)."""

import json
import os
import subprocess
import sys

import pytest

import conftest  # noqa: F401  (forces cpu platform env)
from gunrock_jax.cli import main
from conftest import reference_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(argv):
    return main(argv)


def test_cli_bfs_market(capsys):
    path = reference_dataset("chesapeake.mtx")
    rc = run_cli(["bfs", "market", path, "--undirected",
                  "--src=largestdegree", "--mark-pred"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "CORRECT" in out and "INCORRECT" not in out


def test_cli_bfs_do_rmat(capsys):
    rc = run_cli(["bfs", "rmat", "--rmat_scale=8", "--rmat_edgefactor=8",
                  "--direction-optimized", "--src=randomize",
                  "--iteration-num=2"])
    assert rc == 0
    assert "CORRECT" in capsys.readouterr().out


def test_cli_sssp(capsys):
    rc = run_cli(["sssp", "rmat", "--rmat_scale=8", "--random-edge-values",
                  "--mode=nearfar"])
    assert rc == 0
    assert "CORRECT" in capsys.readouterr().out


def test_cli_pr_json(tmp_path, capsys):
    jf = str(tmp_path / "pr.json")
    rc = run_cli(["pr", "rmat", "--rmat_scale=8", f"--jsonfile={jf}"])
    assert rc == 0
    rec = json.load(open(jf))
    assert rec["primitive"] == "pagerank"
    assert rec["engine"] == "gunrock_jax"
    assert rec["num_vertices"] > 0 and "m_teps" in rec


def test_cli_cc_bc_tc(capsys):
    path = reference_dataset("chesapeake.mtx")
    for prim in ("cc", "bc", "tc"):
        rc = run_cli([prim, "market", path, "--undirected"])
        assert rc == 0, prim
    out = capsys.readouterr().out
    assert out.count("CORRECT") >= 3 and "INCORRECT" not in out


def test_cli_sharded_bfs(capsys):
    rc = run_cli(["bfs", "rmat", "--rmat_scale=8", "--num-shards=2",
                  "--partition-method=biasrandom"])
    assert rc == 0
    assert "CORRECT" in capsys.readouterr().out


@pytest.mark.parametrize("prim", ["hits", "salsa", "topk", "tc"])
def test_cli_sharded_extended_zoo(prim, capsys):
    """--num-shards routes the beyond-parity primitives through their
    shard_map paths and still validates against the CPU oracles."""
    path = reference_dataset("chesapeake.mtx")
    rc = run_cli([prim, "market", path, "--undirected", "--no-cache",
                  "--num-shards=2", "--max-iter=10"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "CORRECT" in out and "INCORRECT" not in out


def test_cli_quick_skips_validation(capsys):
    rc = run_cli(["topk", "rmat", "--rmat_scale=8", "--quick",
                  "--top-nodes=5"])
    assert rc == 0
    assert "CORRECT" not in capsys.readouterr().out


@pytest.mark.parametrize("prim", ["hits", "salsa", "wtf", "topk"])
def test_cli_legacy_primitives(prim, capsys):
    rc = run_cli([prim, "rmat", "--rmat_scale=7", "--max-iter=5",
                  "--quiet"])
    assert rc == 0


def test_cli_module_entry():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run(
        [sys.executable, "-m", "gunrock_jax", "bfs", "rmat",
         "--rmat_scale=6", "--quick", "--quiet"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr
