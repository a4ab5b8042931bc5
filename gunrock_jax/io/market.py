"""Matrix Market (.mtx) graph reader with binary cache.

JAX rebuild of the reference's market reader
(``gunrock/graphio/market.cuh:192`` ReadMarketStream, ``:519``
BuildMarketGraph, binary cache hookup ``:546-566``): parses
pattern/weighted, general/symmetric coordinate files, optionally
symmetrizes, optionally attaches random edge weights, and caches the built
CSR next to the source file as ``<name>.csr.npz`` so repeat loads skip the
text parse.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..graph.csr import CsrGraph, from_coo

__all__ = ["load_market", "parse_market_bytes"]


def parse_market_bytes(
    data: bytes,
    *,
    undirected: Optional[bool] = None,
    random_edge_values: bool = False,
    seed: int = 0,
) -> CsrGraph:
    """Parse Matrix Market coordinate bytes into a CSR graph.

    ``undirected=None`` means "symmetrize iff the header says symmetric"
    (the reference treats ``%%MatrixMarket ... symmetric`` the same way,
    ``market.cuh:238-247``).
    """
    # Split header/comments from the numeric body without decoding the
    # whole file (big .mtx files are hundreds of MB).
    pos = 0
    header = None
    dims_line = None
    n = len(data)
    while pos < n:
        eol = data.find(b"\n", pos)
        if eol == -1:
            eol = n
        line = data[pos:eol].strip()
        if line.startswith(b"%%MatrixMarket"):
            header = line.decode()
        elif line.startswith(b"%") or not line:
            pass
        else:
            dims_line = line.decode()
            pos = eol + 1
            break
        pos = eol + 1
    if header is None or dims_line is None:
        raise ValueError("not a MatrixMarket coordinate file")

    tokens = header.lower().split()
    if "coordinate" not in tokens:
        raise ValueError("only coordinate (sparse) MatrixMarket supported")
    is_pattern = "pattern" in tokens
    is_symmetric = "symmetric" in tokens
    if undirected is None:
        undirected = is_symmetric

    parts = dims_line.split()
    rows, cols, nnz = int(parts[0]), int(parts[1]), int(parts[2])
    num_nodes = max(rows, cols)

    fields = np.empty(0, dtype=np.float64)
    if nnz > 0:
        fields = np.array(data[pos:].split(), dtype=np.float64)

    per_line = 2 if is_pattern else 3
    if nnz > 0 and fields.size % nnz == 0 and fields.size // nnz >= 2:
        per_line = fields.size // nnz
    fields = fields[: nnz * per_line].reshape(nnz, per_line)

    src = fields[:, 0].astype(np.int64) - 1  # 1-based -> 0-based
    dst = fields[:, 1].astype(np.int64) - 1
    values = None
    if per_line >= 3 and not is_pattern:
        values = fields[:, 2].astype(np.float32)

    g = from_coo(num_nodes, src, dst, values, undirected=undirected)
    if random_edge_values and g.edge_values is None:
        g.random_edge_values(seed=seed)
    return g


def load_market(
    path: str,
    *,
    undirected: Optional[bool] = None,
    random_edge_values: bool = False,
    seed: int = 0,
    use_cache: bool = True,
) -> CsrGraph:
    """Load a .mtx file, using/creating a ``.csr.npz`` binary cache.

    Cache key includes the symmetrize/weights options so differently
    configured loads don't collide (the reference only keyed on filename,
    ``market.cuh:546``).
    """
    tag = f".u{int(bool(undirected)) if undirected is not None else 'h'}" \
          f"w{int(random_edge_values)}s{seed}"
    cache = path + tag + ".csr.npz"
    if use_cache and os.path.exists(cache) and \
            os.path.getmtime(cache) >= os.path.getmtime(path):
        return CsrGraph.read_binary(cache)

    with open(path, "rb") as f:
        g = parse_market_bytes(
            f.read(),
            undirected=undirected,
            random_edge_values=random_edge_values,
            seed=seed,
        )
    if use_cache:
        try:
            g.write_binary(cache)
        except OSError:
            pass  # read-only dataset dir; skip caching
    return g
