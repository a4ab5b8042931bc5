"""ctypes bindings to the native C++ host graph builder.

The reference builds host CSRs with OpenMP C++ (``csr.cuh:534-697``,
``util/sort_omp.cuh``); this is the repo's native equivalent
(``native/graph_builder.cpp``), compiled on first use with g++ and
loaded via ctypes (no pybind11 in this image). All entry points degrade
to numpy if the toolchain or the .so is unavailable — correctness never
depends on native code, only host-side build speed.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

__all__ = ["get_lib", "native_available", "coo_to_csr_native",
           "parse_market_body_native", "build_capi_lib"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "native", "graph_builder.cpp")
_SO = os.path.join(_REPO, "native", "libgunrock_host.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _tmp_path(so: str) -> str:
    """Per-process build output, renamed over ``so`` when complete, so
    processes that build at once never write the same file."""
    return f"{so[:-3]}.{os.getpid()}.so.tmp"


def _build() -> bool:
    if not os.path.exists(_SRC):
        return False
    tmp = _tmp_path(_SO)
    cmd = ["g++", "-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17",
           "-o", tmp, _SRC]
    try:
        r = subprocess.run(cmd, capture_output=True, timeout=300)
        if r.returncode != 0:
            return False
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable.
    Disable with GUNROCK_NO_NATIVE=1."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("GUNROCK_NO_NATIVE"):
            return None
        needs_build = (not os.path.exists(_SO)
                       or (os.path.exists(_SRC)
                           and os.path.getmtime(_SO) < os.path.getmtime(_SRC)))
        if needs_build and not _build():
            return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        i64, i32p, i64p, f32p, c_char_p = (
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float),
            ctypes.c_char_p)
        lib.gr_coo_to_csr.restype = i64
        lib.gr_coo_to_csr.argtypes = [i64, i64, i32p, i32p, f32p,
                                      ctypes.c_int, i64p, i32p, f32p]
        lib.gr_csr_dedup.restype = i64
        lib.gr_csr_dedup.argtypes = [i64, i64p, i32p, f32p]
        lib.gr_parse_market_body.restype = i64
        lib.gr_parse_market_body.argtypes = [c_char_p, i64, i64,
                                             ctypes.c_int, i32p, i32p, f32p]
        lib.gr_num_threads.restype = ctypes.c_int
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


_CAPI_SRC = os.path.join(_REPO, "native", "c_api.cpp")
_CAPI_SO = os.path.join(_REPO, "native", "libgunrock_jax.so")


def build_capi_lib() -> Optional[str]:
    """Build the C-callable shared library (``native/c_api.cpp`` —
    the reference's ``gunrock.h`` simplified tier for C consumers,
    ``shared_lib_tests/*.c``). Embeds CPython; the repo root and this
    interpreter's site-packages are baked in so a plain C program can
    dlopen/link it with no environment setup. Returns the .so path or
    None if the toolchain is unavailable."""
    import sys
    import sysconfig
    if not os.path.exists(_CAPI_SRC):
        return None
    if os.path.exists(_CAPI_SO) and \
            os.path.getmtime(_CAPI_SO) >= os.path.getmtime(_CAPI_SRC):
        return _CAPI_SO
    inc = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR") or "/usr/local/lib"
    ver = f"{sys.version_info.major}.{sys.version_info.minor}"
    site_dirs = [p for p in sys.path if p.endswith("site-packages")]
    pypath = ":".join([_REPO] + site_dirs)
    tmp = _tmp_path(_CAPI_SO)
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
           _CAPI_SRC, "-o", tmp,
           f"-I{inc}", f"-L{libdir}", f"-lpython{ver}",
           f"-Wl,-rpath,{libdir}",
           f"-DGRJAX_PYPATH=\"{pypath}\""]
    try:
        r = subprocess.run(cmd, capture_output=True, timeout=300)
        if r.returncode != 0:
            return None
        os.replace(tmp, _CAPI_SO)
        return _CAPI_SO
    except (OSError, subprocess.SubprocessError):
        return None


def _ptr(arr: Optional[np.ndarray], typ):
    if arr is None:
        return ctypes.cast(None, ctypes.POINTER(typ))
    return arr.ctypes.data_as(ctypes.POINTER(typ))


def coo_to_csr_native(num_nodes: int, src: np.ndarray, dst: np.ndarray,
                      values: Optional[np.ndarray], *,
                      remove_self_loops: bool, dedup: bool):
    """Sorted (optionally deduped) CSR from COO via the native builder.

    Returns ``(row_offsets int64, col_indices int32, values float32|None)``
    or ``None`` when the native library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    e = int(src.shape[0])
    src32 = np.ascontiguousarray(src, dtype=np.int32)
    dst32 = np.ascontiguousarray(dst, dtype=np.int32)
    vals = (np.ascontiguousarray(values, dtype=np.float32)
            if values is not None else None)
    row = np.zeros(num_nodes + 1, dtype=np.int64)
    col = np.empty(e, dtype=np.int32)
    val_out = np.empty(e, dtype=np.float32) if vals is not None else None

    n_out = lib.gr_coo_to_csr(
        num_nodes, e,
        _ptr(src32, ctypes.c_int32), _ptr(dst32, ctypes.c_int32),
        _ptr(vals, ctypes.c_float), int(remove_self_loops),
        _ptr(row, ctypes.c_int64), _ptr(col, ctypes.c_int32),
        _ptr(val_out, ctypes.c_float))
    if n_out < 0:
        return None
    if dedup:
        n_out = lib.gr_csr_dedup(num_nodes, _ptr(row, ctypes.c_int64),
                                 _ptr(col, ctypes.c_int32),
                                 _ptr(val_out, ctypes.c_float))
    col = col[:n_out].copy()
    if val_out is not None:
        val_out = val_out[:n_out].copy()
    return row, col, val_out


def parse_market_body_native(body: bytes, nnz_max: int, has_values: bool):
    """Parse the numeric body of a .mtx file. Returns
    ``(src, dst, vals|None)`` (0-based int32) or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    src = np.empty(nnz_max, dtype=np.int32)
    dst = np.empty(nnz_max, dtype=np.int32)
    vals = np.empty(nnz_max, dtype=np.float32) if has_values else None
    n = lib.gr_parse_market_body(
        body, len(body), nnz_max, int(has_values),
        _ptr(src, ctypes.c_int32), _ptr(dst, ctypes.c_int32),
        _ptr(vals, ctypes.c_float))
    if n < 0:
        return None
    src = src[:n].copy()
    dst = dst[:n].copy()
    if vals is not None:
        vals = vals[:n].copy()
    return src, dst, vals
