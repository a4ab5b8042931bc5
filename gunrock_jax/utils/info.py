"""Run-record JSON statistics (reference ``gunrock/util/info.cuh``).

Every primitive run produces an ``info`` dict matching the reference's
JSON schema where it makes sense here: primitive name, graph shape,
timing splits (load/preprocess/process/postprocess, ``info.cuh:1309``),
``m_teps = edges_visited / (elapsed_ms * 1000)`` (``info.cuh:1431``),
``search_depth``, per-iteration frontier sizes (``info.cuh:684-709``),
plus system/device info. ``write_info`` mirrors ``--jsonfile/--jsondir``.
"""

from __future__ import annotations

import datetime
import json
import os
import platform
import sys
from typing import Optional

import numpy as np

__all__ = ["make_info", "write_info"]


_GIT_SHA: Optional[str] = None


def _git_sha() -> str:
    """Repo git SHA for run records (reference ``util/gitsha1.h``)."""
    global _GIT_SHA
    if _GIT_SHA is None:
        import subprocess
        try:
            _GIT_SHA = subprocess.run(
                ["git", "-C", os.path.dirname(os.path.dirname(
                    os.path.dirname(os.path.abspath(__file__)))),
                 "rev-parse", "HEAD"],
                capture_output=True, text=True, timeout=5,
            ).stdout.strip() or "unknown"
        except Exception:
            _GIT_SHA = "unknown"
    return _GIT_SHA


def _device_info() -> dict:
    try:
        import jax
        d = jax.devices()[0]
        return {
            "name": str(getattr(d, "device_kind", d.platform)),
            "platform": d.platform,
            "num_devices": jax.device_count(),
        }
    except Exception:  # pragma: no cover - device probing is best-effort
        return {"name": "unknown", "platform": "unknown", "num_devices": 0}


def make_info(*, primitive: str, graph, stats=None, timer=None,
              edges_visited: Optional[int] = None,
              extra: Optional[dict] = None) -> dict:
    info: dict = {
        "primitive": primitive,
        "engine": "gunrock_jax",
        "command_line": " ".join(sys.argv),
        "git_commit_sha1": _git_sha(),
        "time": datetime.datetime.now().isoformat(),
        "sysinfo": {"machine": platform.machine(),
                    "system": platform.system(),
                    "python": platform.python_version()},
        "gpuinfo": _device_info(),
        "num_vertices": int(graph.num_nodes),
        "num_edges": int(graph.num_edges),
    }
    if timer is not None:
        for k, v in timer.splits.items():
            info[k] = v * 1000.0  # seconds -> ms
    if stats is not None:
        iters = int(stats.iteration)
        trace = np.asarray(stats.frontier_trace)
        info["num_iterations"] = iters
        info["nodes_queued"] = int(float(stats.nodes_queued))
        info["edges_queued"] = int(float(stats.edges_queued))
        info["frontier_overflow"] = bool(stats.overflow)
        info["per_iteration_frontier"] = trace[trace >= 0].tolist()
    if edges_visited is not None:
        info["edges_visited"] = edges_visited
        elapsed_ms = info.get("process_ms", 0.0)
        if elapsed_ms > 0:
            # m_teps = edges_visited / (elapsed_ms * 1000), info.cuh:1431
            info["m_teps"] = edges_visited / (elapsed_ms * 1000.0)
    if extra:
        info.update(extra)
    # avg_duty (reference info.cuh:1380-1385): fraction of the enactment
    # wall spent inside per-iteration kernel work. Only meaningful on
    # instrumented runs, where per-iteration wall records exist.
    per_iter = info.get("per_iteration")
    process_ms = info.get("process_ms", 0.0)
    if per_iter and process_ms > 0:
        kernel_ms = sum(r.get("ms", 0.0) for r in per_iter
                        if isinstance(r, dict))
        info["avg_duty"] = min(kernel_ms / process_ms, 1.0)
    # Per-phase duty split (reference per-kernel lifetimes +
    # subqueue/fullqueue stage timers, util/kernel_runtime_stats.cuh,
    # enactor_types.cuh:67-72): total ms and iteration count per kernel
    # family — pull pass / push ladder / deep micro-loop (single chip),
    # forward/backward (BC), exchange/local (sharded supersteps).
    if per_iter and any(isinstance(r, dict) and "phase" in r
                        for r in per_iter):
        phase_ms: dict = {}
        phase_iters: dict = {}
        for r in per_iter:
            if isinstance(r, dict) and "phase" in r:
                phase_ms[r["phase"]] = (phase_ms.get(r["phase"], 0.0)
                                        + r.get("ms", 0.0))
                phase_iters[r["phase"]] = phase_iters.get(r["phase"], 0) + 1
        info["phase_ms"] = {k: round(v, 3) for k, v in phase_ms.items()}
        info["phase_iterations"] = phase_iters
    return info


def write_info(info: dict, jsonfile: Optional[str] = None,
               jsondir: Optional[str] = None) -> Optional[str]:
    """Write the run record (reference ``--jsonfile`` / ``--jsondir``)."""
    path = jsonfile
    if path is None and jsondir is not None:
        stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
        path = os.path.join(jsondir,
                            f"{info.get('primitive', 'run')}_{stamp}.json")
    if path is None:
        return None
    with open(path, "w") as f:
        json.dump(info, f, indent=2)
    return path
