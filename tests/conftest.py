"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-chip hardware is not available in CI; like the reference's
``--device=0,0`` trick (two logical GPUs on one physical device,
``CMakeLists.txt:389-421``), we test sharding against
``--xla_force_host_platform_device_count=8`` CPU devices.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "2")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import gunrock_jax as gt  # noqa: E402
from gunrock_jax.utils.runtime import enable_compile_cache  # noqa: E402

# Persistent compile cache, by the entry points' rule: the enactor
# programs (ladder switch x push/pull branches) take tens of seconds to
# compile on CPU; the CLI subprocess tests apply the same rule and so
# share the directory.
enable_compile_cache()

REFERENCE_SMALL = "/root/reference/dataset/small"
REFERENCE_EXAMPLE = "/root/reference/simple_example"


def reference_dataset(name: str):
    """Path to a bundled reference dataset, or skip if unavailable."""
    for base in (REFERENCE_SMALL, REFERENCE_EXAMPLE):
        p = os.path.join(base, name)
        if os.path.exists(p):
            return p
    pytest.skip(f"reference dataset {name} not available")


@pytest.fixture(scope="session")
def chesapeake():
    """The reference ctest graph (dataset/small/chesapeake.mtx)."""
    return gt.io.load_market(reference_dataset("chesapeake.mtx"),
                             undirected=True, use_cache=False)


@pytest.fixture(scope="session")
def bips98():
    """The reference simple_example graph (bips98_606.mtx)."""
    return gt.io.load_market(reference_dataset("bips98_606.mtx"),
                             undirected=True, use_cache=False)


@pytest.fixture(scope="session")
def rmat_small():
    """Deterministic small scale-free graph for oracle tests."""
    return gt.io.rmat(scale=10, edge_factor=8, seed=42, undirected=True)


@pytest.fixture(scope="session")
def road_like():
    """Deterministic high-diameter graph (grid), exercising deep BFS."""
    n = 32
    idx = np.arange(n * n).reshape(n, n)
    src = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    dst = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    return gt.from_coo(n * n, src, dst, undirected=True)


@pytest.fixture(scope="session")
def road_big():
    """Grid large enough that the deep-regime micro-loops engage
    (non-DO BFS: fcap >= models.bfs.DEEP_CAP; SSSP:
    fcap >= 2*models.sssp.DEEP_CAP, with fcap ~ v_pad*queue_sizing)."""
    n = 192
    idx = np.arange(n * n).reshape(n, n)
    src = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    dst = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    return gt.from_coo(n * n, src, dst, undirected=True)
