"""gunrock_jax — a frontier-centric graph analytics framework in JAX.

A from-scratch rebuild of the capabilities of the Gunrock GPU graph
library (reference: gwcloudlab/gunrock) on JAX/XLA: bulk-synchronous
advance / filter / compute operators over HBM-resident CSR graphs, a
primitive zoo (BFS, SSSP, PageRank, CC, BC, HITS, SALSA, WTF, TopK), and
multi-chip scaling via vertex partitioning + all-to-all frontier exchange
over a ``jax.sharding.Mesh``.

Quick start::

    import gunrock_jax as gt
    g = gt.io.load_market("graph.mtx", undirected=True)
    result = gt.bfs(g, src=0, mark_preds=True)
    result.labels  # numpy depths
"""

from . import graph, io, ops, models, parallel, utils  # noqa: F401
from .graph.csr import CsrGraph, from_coo  # noqa: F401
from .graph.device import DeviceGraph, to_device  # noqa: F401
from .models import (  # noqa: F401
    bfs, sssp, pagerank, cc, bc, hits, salsa, wtf, topk, sample, tc,
)

__version__ = "0.1.0"
