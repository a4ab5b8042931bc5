"""Host-side CSR graph container (numpy).

JAX rebuild of the reference's host CSR layer
(``gunrock/csr.cuh:44-63`` — ``Csr<VertexId, SizeT, Value>`` with
``row_offsets/column_indices/edge_values/node_values``, COO->CSR build with
sort + dedup + self-loop removal at ``csr.cuh:534-697``, binary cache at
``csr.cuh:244-266,412-451``, degree histogram ``csr.cuh:707`` and
largest-degree source ``csr.cuh:858``).

Everything here is pure numpy and runs on the host; the device-resident
counterpart (padded, int32, jnp) lives in :mod:`gunrock_jax.graph.device`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

__all__ = ["CsrGraph", "from_coo"]


@dataclasses.dataclass
class CsrGraph:
    """Compressed-sparse-row graph on the host.

    ``row_offsets`` has ``num_nodes + 1`` entries; ``col_indices`` has
    ``num_edges`` entries. ``edge_values``/``node_values`` are optional
    payload arrays (reference: ``csr.cuh:57-60``).
    """

    num_nodes: int
    row_offsets: np.ndarray          # (V+1,) int64
    col_indices: np.ndarray          # (E,)  int32/int64
    edge_values: Optional[np.ndarray] = None   # (E,) float32
    node_values: Optional[np.ndarray] = None   # (V,) float32
    undirected: bool = False

    # ---------------------------------------------------------------- basics
    @property
    def num_edges(self) -> int:
        return int(self.col_indices.shape[0])

    @property
    def out_degrees(self) -> np.ndarray:
        return np.diff(self.row_offsets)

    def edge_sources(self) -> np.ndarray:
        """Expand row_offsets back to a per-edge source array (COO rows)."""
        return np.repeat(
            np.arange(self.num_nodes, dtype=self.col_indices.dtype),
            self.out_degrees,
        )

    # ----------------------------------------------------------- transforms
    def csc(self) -> "CsrGraph":
        """Build the transpose (CSC viewed as a CSR of the reverse graph).

        The reference stores the inverse CSR as ``column_offsets/row_indices``
        in GraphSlice (``gunrock/app/problem_base.cuh:97-98``,
        ``csr.cuh:127`` CsrToCsc).
        """
        src = self.edge_sources()
        return from_coo(
            self.num_nodes,
            self.col_indices,
            src,
            values=self.edge_values,
            remove_self_loops=False,
            dedup=False,
            undirected=False,
        )

    # ------------------------------------------------------------ analysis
    def degree_histogram(self) -> np.ndarray:
        """log2-bucketed out-degree histogram (reference ``csr.cuh:707``)."""
        deg = self.out_degrees
        max_log = int(np.ceil(np.log2(max(int(deg.max(initial=0)), 1) + 1))) + 1
        hist = np.zeros(max_log + 1, dtype=np.int64)
        hist[0] = int((deg == 0).sum())
        nz = deg[deg > 0]
        if nz.size:
            buckets = np.floor(np.log2(nz)).astype(np.int64) + 1
            np.add.at(hist, buckets, 1)
        return hist

    def largest_degree_vertex(self) -> int:
        """Vertex with the largest out-degree (reference ``csr.cuh:858``,
        used for ``--src=largestdegree``)."""
        return int(np.argmax(self.out_degrees))

    def random_edge_values(self, lo: float = 0.0, hi: float = 64.0,
                           seed: int = 0) -> None:
        """Attach uniform random edge weights (reference market reader's
        ``RANDOM_EDGE_VALUES``, ``graphio/market.cuh``)."""
        rng = np.random.default_rng(seed)
        self.edge_values = rng.uniform(lo, hi, self.num_edges).astype(np.float32)

    # --------------------------------------------------------- binary cache
    def write_binary(self, path: str) -> None:
        """Cache to ``.csr.npz`` (reference ``csr.cuh:244`` WriteBinary)."""
        payload = {
            "num_nodes": np.int64(self.num_nodes),
            "row_offsets": self.row_offsets,
            "col_indices": self.col_indices,
            "undirected": np.bool_(self.undirected),
        }
        if self.edge_values is not None:
            payload["edge_values"] = self.edge_values
        if self.node_values is not None:
            payload["node_values"] = self.node_values
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)

    @staticmethod
    def read_binary(path: str) -> "CsrGraph":
        """Load from ``.csr.npz`` (reference ``csr.cuh:412`` FromCsr)."""
        with np.load(path) as z:
            return CsrGraph(
                num_nodes=int(z["num_nodes"]),
                row_offsets=z["row_offsets"],
                col_indices=z["col_indices"],
                edge_values=z["edge_values"] if "edge_values" in z else None,
                node_values=z["node_values"] if "node_values" in z else None,
                undirected=bool(z["undirected"]),
            )


def from_coo(
    num_nodes: int,
    src: np.ndarray,
    dst: np.ndarray,
    values: Optional[np.ndarray] = None,
    *,
    remove_self_loops: bool = True,
    dedup: bool = True,
    undirected: bool = False,
) -> CsrGraph:
    """Build a CSR graph from COO edge tuples.

    Mirrors the semantics of the reference's ``Csr::FromCoo``
    (``csr.cuh:534-697``): optional symmetrization (add reverse edges),
    row-major sort, duplicate-edge removal (first value wins), self-loop
    removal. Implemented with vectorized numpy instead of the reference's
    OpenMP mergesort (``util/sort_omp.cuh``).
    """
    src = np.asarray(src)
    dst = np.asarray(dst)
    if values is not None:
        values = np.asarray(values, dtype=np.float32)

    if undirected:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        if values is not None:
            values = np.concatenate([values, values])

    # Fast path: native OpenMP builder (graph_builder.cpp), the analogue
    # of the reference's parallel host build; falls back to numpy below.
    from .native import coo_to_csr_native
    built = coo_to_csr_native(int(num_nodes), src, dst, values,
                              remove_self_loops=remove_self_loops,
                              dedup=dedup)
    if built is not None:
        row_offsets, col, vals = built
        return CsrGraph(num_nodes=int(num_nodes), row_offsets=row_offsets,
                        col_indices=col, edge_values=vals,
                        undirected=undirected)

    if remove_self_loops:
        keep = src != dst
        src, dst = src[keep], dst[keep]
        if values is not None:
            values = values[keep]

    # Row-major stable sort so the first-listed duplicate's value wins,
    # matching the reference's keep-first semantics.
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    if values is not None:
        values = values[order]

    if dedup and src.size:
        keep = np.ones(src.size, dtype=bool)
        keep[1:] = (src[1:] != src[:-1]) | (dst[1:] != dst[:-1])
        src, dst = src[keep], dst[keep]
        if values is not None:
            values = values[keep]

    counts = np.bincount(src, minlength=num_nodes).astype(np.int64)
    row_offsets = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=row_offsets[1:])

    return CsrGraph(
        num_nodes=int(num_nodes),
        row_offsets=row_offsets,
        col_indices=dst.astype(np.int32),
        edge_values=values,
        undirected=undirected,
    )
