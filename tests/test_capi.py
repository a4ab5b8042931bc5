"""C-ABI tier: build ``native/libgunrock_jax.so``, compile the plain-C
consumer (``examples/capi_example.c``), and run it end-to-end — the
reference's ``shared_lib_tests`` ctest analogue (``gunrock.h:173-347``,
``shared_lib_tests/shared_lib_bfs.c``)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_capi_python_bridge():
    """gunrock_jax.capi over raw pointer addresses (what the .so calls)."""
    from gunrock_jax import capi

    row = np.array([0, 2, 4, 7, 10, 12, 14, 14], np.int32)
    col = np.array([1, 2, 0, 2, 0, 1, 3, 2, 4, 5, 3, 5, 3, 4], np.int32)
    labels = np.full(7, -9, np.int32)
    preds = np.full(7, -9, np.int32)
    ms = capi.bfs_c(labels.ctypes.data, preds.ctypes.data, 7, 14,
                    row.ctypes.data, col.ctypes.data, 0, 1, 0)
    assert ms >= 0
    np.testing.assert_array_equal(labels, [0, 1, 1, 2, 3, 3, -1])

    comp = np.zeros(7, np.int32)
    count = np.zeros(1, np.int32)
    ms = capi.cc_c(comp.ctypes.data, count.ctypes.data, 7, 14,
                   row.ctypes.data, col.ctypes.data)
    assert ms >= 0 and count[0] == 2


@pytest.mark.skipif(shutil.which("gcc") is None and
                    shutil.which("g++") is None,
                    reason="no C toolchain")
def test_capi_shared_lib_consumer(tmp_path):
    from gunrock_jax.graph.native import build_capi_lib

    so = build_capi_lib()
    if so is None:
        pytest.skip("C-ABI lib unavailable (no libpython to embed)")

    cc = shutil.which("gcc") or shutil.which("g++")
    exe = str(tmp_path / "capi_example")
    native = os.path.join(REPO, "native")
    r = subprocess.run(
        [cc, os.path.join(REPO, "examples", "capi_example.c"), "-o", exe,
         f"-I{native}", f"-L{native}", "-lgunrock_jax",
         f"-Wl,-rpath,{native}", "-lm"],
        capture_output=True, text=True)
    assert r.returncode == 0, r.stderr

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONHOME", None)
    r = subprocess.run([exe], capture_output=True, text=True, env=env,
                       timeout=600)
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "ALL OK" in r.stdout, r.stdout
