"""Python side of the C ABI (``native/c_api.cpp``).

Each ``*_c`` function receives raw pointer addresses + sizes as
integers, wraps them as zero-copy numpy views (the caller's buffers),
runs the corresponding primitive, writes results in place, and returns
elapsed process time in ms — mirroring the reference's simplified C
tier semantics (``gunrock.h:173-347`` implemented by ``app/*_app.cu``,
consumed by ``shared_lib_tests/*.c``).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

__all__ = ["bfs_c", "bc_c", "cc_c", "sssp_c", "pagerank_c"]


def _view(addr: int, n: int, dtype):
    """Zero-copy numpy view over a foreign buffer."""
    ct = {np.int32: ctypes.c_int32, np.float32: ctypes.c_float}[dtype]
    buf = (ct * n).from_address(addr)
    return np.ctypeslib.as_array(buf)


def _graph(num_nodes, num_edges, row_addr, col_addr, val_addr=0):
    from .graph.csr import CsrGraph
    row = _view(row_addr, num_nodes + 1, np.int32).astype(np.int64)
    col = _view(col_addr, num_edges, np.int32).copy()
    vals = (_view(val_addr, num_edges, np.float32).copy()
            if val_addr else None)
    return CsrGraph(num_nodes=int(num_nodes), row_offsets=row,
                    col_indices=col, edge_values=vals)


def bfs_c(label_addr, pred_addr, num_nodes, num_edges, row_addr,
          col_addr, source, mark_preds, direction_optimized):
    from .models import bfs
    g = _graph(num_nodes, num_edges, row_addr, col_addr)
    r = bfs(g, int(source), mark_preds=bool(mark_preds),
            direction_optimized=bool(direction_optimized))
    _view(label_addr, num_nodes, np.int32)[:] = r.labels
    if mark_preds and pred_addr:
        _view(pred_addr, num_nodes, np.int32)[:] = r.preds
    return float(r.info["process_ms"])


def bc_c(scores_addr, num_nodes, num_edges, row_addr, col_addr, source):
    from .models import bc
    g = _graph(num_nodes, num_edges, row_addr, col_addr)
    r = bc(g, int(source) if source >= 0 else None)
    _view(scores_addr, num_nodes, np.float32)[:] = r.bc_values
    return float(r.info["process_ms"])


def cc_c(comp_addr, count_addr, num_nodes, num_edges, row_addr,
         col_addr):
    from .models import cc
    g = _graph(num_nodes, num_edges, row_addr, col_addr)
    r = cc(g)
    _view(comp_addr, num_nodes, np.int32)[:] = r.components
    _view(count_addr, 1, np.int32)[0] = r.num_components
    return float(r.info["process_ms"])


def sssp_c(dist_addr, pred_addr, num_nodes, num_edges, row_addr,
           col_addr, val_addr, source, mark_preds):
    from .models import sssp
    g = _graph(num_nodes, num_edges, row_addr, col_addr, val_addr)
    r = sssp(g, int(source), mark_preds=bool(mark_preds))
    _view(dist_addr, num_nodes, np.float32)[:] = r.distances
    if mark_preds and pred_addr:
        _view(pred_addr, num_nodes, np.int32)[:] = r.preds
    return float(r.info["process_ms"])


def pagerank_c(ids_addr, rank_addr, num_nodes, num_edges, row_addr,
               col_addr, normalized):
    from .models import pagerank
    g = _graph(num_nodes, num_edges, row_addr, col_addr)
    r = pagerank(g, normalized=bool(normalized))
    _view(ids_addr, num_nodes, np.int32)[:] = r.node_ids
    _view(rank_addr, num_nodes, np.float32)[:] = r.ranks[r.node_ids]
    return float(r.info["process_ms"])
