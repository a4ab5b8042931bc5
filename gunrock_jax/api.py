"""Simplified array API — parity with the reference's C entry points.

The reference exposes two API tiers in ``gunrock/gunrock.h``: full
``gunrock_<prim>(GRGraph*, GRSetup)`` calls and *simplified* versions
taking raw CSR arrays (``bfs/bc/cc/sssp/pagerank``, ``gunrock.h:194-347``,
implemented in ``app/*_app.cu``). This module is the second tier: plain
functions over numpy CSR arrays, no graph object required — the natural
binding surface for non-Python callers (ctypes/cffi users load numpy
arrays and call these).

    labels = gunrock_jax.api.bfs(num_nodes, row_offsets, col_indices, src=0)
"""

from __future__ import annotations


from typing import Union

import numpy as np

from .graph.csr import CsrGraph

__all__ = ["bfs", "sssp", "bc", "cc", "pagerank", "tc", "topk"]


def _graph(num_nodes: int, row_offsets, col_indices,
           edge_values=None, undirected: bool = False) -> CsrGraph:
    return CsrGraph(
        num_nodes=int(num_nodes),
        row_offsets=np.asarray(row_offsets, dtype=np.int64),
        col_indices=np.asarray(col_indices, dtype=np.int32),
        edge_values=(np.asarray(edge_values, dtype=np.float32)
                     if edge_values is not None else None),
        undirected=undirected,
    )


def bfs(num_nodes: int, row_offsets, col_indices, src: int = 0, *,
        mark_preds: bool = False, direction_optimized: bool = False):
    """Reference ``bfs()`` (gunrock.h:194): returns int32 labels[V]
    (and preds[V] when mark_preds)."""
    from .models import bfs as _bfs
    r = _bfs(_graph(num_nodes, row_offsets, col_indices), int(src),
             mark_preds=mark_preds, direction_optimized=direction_optimized)
    return (r.labels, r.preds) if mark_preds else r.labels


def sssp(num_nodes: int, row_offsets, col_indices, edge_values,
         src: int = 0, *, mark_preds: bool = False):
    """Reference ``sssp()`` (gunrock.h:253): float32 distances[V]."""
    from .models import sssp as _sssp
    r = _sssp(_graph(num_nodes, row_offsets, col_indices, edge_values),
              int(src), mark_preds=mark_preds)
    return (r.distances, r.preds) if mark_preds else r.distances


def bc(num_nodes: int, row_offsets, col_indices,
       src: Union[int, None] = -1):
    """Reference ``bc()`` (gunrock.h:200): float32 centrality[V]."""
    from .models import bc as _bc
    r = _bc(_graph(num_nodes, row_offsets, col_indices), src)
    return r.bc_values


def cc(num_nodes: int, row_offsets, col_indices):
    """Reference ``cc()``: int32 component[V]; returns (components, count)."""
    from .models import cc as _cc
    r = _cc(_graph(num_nodes, row_offsets, col_indices))
    return r.components, r.num_components


def pagerank(num_nodes: int, row_offsets, col_indices, *,
             damping: float = 0.85, max_iters: int = 50,
             threshold: float = 1e-6):
    """Reference ``pagerank()``: (node_ids, ranks) sorted by rank desc."""
    from .models import pagerank as _pr
    r = _pr(_graph(num_nodes, row_offsets, col_indices), damping=damping,
            max_iters=max_iters, threshold=threshold)
    return r.node_ids, r.ranks[r.node_ids]


def tc(num_nodes: int, row_offsets, col_indices) -> int:
    """Triangle count over a symmetric CSR."""
    from .models.tc import tc as _tc
    return _tc(_graph(num_nodes, row_offsets, col_indices,
                      undirected=True)).total


def topk(num_nodes: int, row_offsets, col_indices, k: int = 10):
    from .models import topk as _topk
    r = _topk(_graph(num_nodes, row_offsets, col_indices), k=k)
    return r.node_ids, r.centralities
