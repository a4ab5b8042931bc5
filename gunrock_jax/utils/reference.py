"""CPU reference implementations (oracles) for primitive validation.

The reference validates every primitive against a CPU implementation in
the same test binary (e.g. ReferenceBFS ``tests/bfs/test_bfs.cu:186-257``,
CPU Dijkstra in test_sssp.cu, Brandes BC in test_bc.cu); these are the
equivalent simple, obviously-correct host oracles. They are shipped in
the package (not just the test tree) because the CLI drivers offer the
same ``--quick``-off validation path as the reference's test binaries.
"""

from __future__ import annotations

import heapq
from collections import deque

import numpy as np


def bfs_levels(g, src: int) -> np.ndarray:
    """Level-synchronous vectorised BFS (same labels as :func:`cpu_bfs`,
    numpy speed for graphs with ~10^8 edges)."""
    n = g.num_nodes
    row, col = g.row_offsets, g.col_indices
    labels = np.full(n, -1, dtype=np.int32)
    labels[src] = 0
    frontier = np.array([src], dtype=np.int64)
    depth = 0
    while frontier.size:
        depth += 1
        starts = row[frontier].astype(np.int64)
        counts = row[frontier + 1].astype(np.int64) - starts
        total = int(counts.sum())
        if total == 0:
            break
        # Edge ids of the whole frontier: per-vertex arange via repeat.
        base = np.repeat(starts - np.cumsum(counts) + counts, counts)
        nbrs = col[base + np.arange(total, dtype=np.int64)]
        hit = np.zeros(n, dtype=bool)
        hit[nbrs] = True
        hit &= labels == -1
        frontier = np.flatnonzero(hit)
        labels[frontier] = depth
    return labels


def _weighted_csr(g):
    """scipy CSR of ``g`` with duplicate (src, dst) edges reduced to
    their minimum weight (a csr_matrix would sum them)."""
    from scipy.sparse import csr_matrix
    src = g.edge_sources().astype(np.int64)
    dst = g.col_indices.astype(np.int64)
    w = g.edge_values.astype(np.float64)
    key = src * g.num_nodes + dst
    if key.size and np.any(np.diff(key) <= 0):
        order = np.lexsort((w, key))
        key, w = key[order], w[order]
        first = np.r_[True, key[1:] != key[:-1]]
        key, w = key[first], w[first]
        src, dst = key // g.num_nodes, key % g.num_nodes
    row = np.zeros(g.num_nodes + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=g.num_nodes), out=row[1:])
    return csr_matrix((w, dst, row), shape=(g.num_nodes, g.num_nodes))


def sssp_dijkstra(g, src: int) -> np.ndarray:
    """Dijkstra through ``scipy.sparse.csgraph`` (same distances as
    :func:`cpu_sssp`; zero-weight edges count as edges)."""
    from scipy.sparse.csgraph import dijkstra
    return dijkstra(_weighted_csr(g), directed=True, indices=int(src))


def cc_min_label(g) -> np.ndarray:
    """Weakly connected components through ``scipy.sparse.csgraph``,
    ids normalised to the minimum vertex id (same as :func:`cpu_cc`)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components
    n = g.num_nodes
    mat = csr_matrix((np.ones(g.num_edges, dtype=np.int8), g.col_indices,
                      g.row_offsets), shape=(n, n))
    _, comp = connected_components(mat, directed=True, connection="weak")
    mins = np.full(comp.max(initial=0) + 1, n, dtype=np.int64)
    np.minimum.at(mins, comp, np.arange(n))
    return mins[comp].astype(np.int32)


def cpu_bfs(g, src: int) -> np.ndarray:
    """Plain queue BFS; labels[v] = depth, -1 unreachable."""
    labels = np.full(g.num_nodes, -1, dtype=np.int32)
    labels[src] = 0
    q = deque([src])
    row, col = g.row_offsets, g.col_indices
    while q:
        u = q.popleft()
        for e in range(row[u], row[u + 1]):
            v = col[e]
            if labels[v] == -1:
                labels[v] = labels[u] + 1
                q.append(v)
    return labels


def cpu_sssp(g, src: int) -> np.ndarray:
    """Dijkstra; dist[v] = shortest distance, +inf unreachable."""
    dist = np.full(g.num_nodes, np.inf, dtype=np.float64)
    dist[src] = 0.0
    # float64 weights: under NumPy 2 promotion a Python float plus a
    # float32 scalar stays float32.
    row, col = g.row_offsets, g.col_indices
    w = g.edge_values.astype(np.float64)
    pq = [(0.0, src)]
    while pq:
        d, u = heapq.heappop(pq)
        if d > dist[u]:
            continue
        for e in range(row[u], row[u + 1]):
            v, nd = col[e], d + w[e]
            if nd < dist[v]:
                dist[v] = nd
                heapq.heappush(pq, (nd, v))
    return dist


def cpu_pagerank(g, damping: float = 0.85, max_iters: int = 100,
                 tol: float = 1e-6, normalized: bool = True) -> np.ndarray:
    """Power-iteration PageRank matching the reference semantics
    (``tests/pr/test_pr.cu`` SimpleReferencePr)."""
    n = g.num_nodes
    deg = np.diff(g.row_offsets).astype(np.float64)
    inv_deg = np.where(deg > 0, 1.0 / np.maximum(deg, 1.0), 0.0)
    src_of_edge = g.edge_sources()
    rank = np.full(n, 1.0 / n, dtype=np.float64)
    for _ in range(max_iters):
        contrib = (rank * inv_deg)[src_of_edge]
        incoming = np.bincount(g.col_indices, weights=contrib, minlength=n)
        new_rank = (1.0 - damping) / n + damping * incoming
        if not normalized:
            new_rank = (1.0 - damping) + damping * incoming
        if np.abs(new_rank - rank).sum() < tol:
            rank = new_rank
            break
        rank = new_rank
    return rank


def cpu_cc(g) -> np.ndarray:
    """Connected components via union-find; returns component ids
    normalized to the minimum vertex id in each component."""
    parent = np.arange(g.num_nodes)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    src_of_edge = g.edge_sources()
    for u, v in zip(src_of_edge, g.col_indices):
        ru, rv = find(u), find(v)
        if ru != rv:
            parent[max(ru, rv)] = min(ru, rv)
    return np.array([find(x) for x in range(g.num_nodes)], dtype=np.int32)


def cpu_bc(g, src: int = -1) -> np.ndarray:
    """Brandes betweenness centrality (reference test_bc.cu RefCPUBC).

    ``src=-1`` computes over all sources; otherwise single-source
    dependency accumulation (what the reference computes per run, scaled
    by 0.5 for undirected double-counting).
    """
    n = g.num_nodes
    bc = np.zeros(n, dtype=np.float64)
    row, col = g.row_offsets, g.col_indices
    sources = range(n) if src < 0 else [src]
    for s in sources:
        sigma = np.zeros(n)
        sigma[s] = 1.0
        dist = np.full(n, -1, dtype=np.int64)
        dist[s] = 0
        order = []
        q = deque([s])
        while q:
            u = q.popleft()
            order.append(u)
            for e in range(row[u], row[u + 1]):
                v = col[e]
                if dist[v] == -1:
                    dist[v] = dist[u] + 1
                    q.append(v)
                if dist[v] == dist[u] + 1:
                    sigma[v] += sigma[u]
        delta = np.zeros(n)
        for u in reversed(order):
            for e in range(row[u], row[u + 1]):
                v = col[e]
                if dist[v] == dist[u] + 1 and sigma[v] > 0:
                    delta[u] += sigma[u] / sigma[v] * (1.0 + delta[v])
            if u != s:
                bc[u] += delta[u]
    return bc * 0.5


def cpu_tc(g) -> int:
    """Triangle count via per-edge sorted-adjacency intersection
    (node-iterator; independent of the device DAG-probe algorithm)."""
    row, col = g.row_offsets, g.col_indices
    adj = [np.sort(col[row[v]:row[v + 1]]) for v in range(g.num_nodes)]
    total = 0
    src = g.edge_sources()
    for u, v in zip(src, col):
        if u < v:
            total += np.intersect1d(adj[u], adj[v],
                                    assume_unique=True).size
    # Each triangle counted once per one of its three u<v edges minus
    # shared corners: the u<v filter counts each triangle exactly 3x/2...
    # precisely: for undirected simple graphs, each triangle {a,b,c} has
    # 3 edges with u<v, each contributing 1 => total = 3 * triangles.
    return total // 3


def cpu_salsa(g, max_iters: int = 50):
    """SALSA hub/authority scores — random-walk normalized ping-pong
    (models/salsa.py semantics; the reference's ReferenceSALSA,
    ``tests/salsa/test_salsa.cu:188``, is an empty stub, so this oracle
    is the independent numpy formulation of the documented recurrence):

        auth[v] = Σ_{(u,v)}  hub[u]  / outdeg(u)
        hub[u]  = Σ_{(u,v)}  auth[v] / indeg(v)
    """
    n = g.num_nodes
    src = g.edge_sources()
    dst = g.col_indices
    outdeg = np.diff(g.row_offsets).astype(np.float64)
    indeg = np.bincount(dst, minlength=n).astype(np.float64)
    inv_out = np.where(outdeg > 0, 1.0 / np.maximum(outdeg, 1.0), 0.0)
    inv_in = np.where(indeg > 0, 1.0 / np.maximum(indeg, 1.0), 0.0)
    hub = np.full(n, 1.0 / n)
    auth = hub.copy()
    for _ in range(max_iters):
        auth = np.bincount(dst, weights=(hub * inv_out)[src], minlength=n)
        hub = np.bincount(src, weights=(auth * inv_in)[dst], minlength=n)
    return hub, auth


def cpu_wtf(g, src: int, *, delta: float = 0.85, alpha: float = 0.2,
            max_iters: int = 50, threshold: float = 1e-6,
            cot_size: int = 1000):
    """Who-To-Follow oracle: PPR -> circle of trust -> personalized SALSA
    (reference ``wtf_enactor.cuh:236-565`` phase semantics; see
    models/wtf.py for the per-phase recurrences this mirrors).
    Returns (refscore, ppr)."""
    n = g.num_nodes
    esrc = g.edge_sources()
    edst = g.col_indices
    outdeg = np.diff(g.row_offsets).astype(np.float64)
    inv_out = np.where(outdeg > 0, 1.0 / np.maximum(outdeg, 1.0), 0.0)

    # phase 1: personalized PageRank
    rank = np.full(n, 1.0 / n)
    e_src_vec = np.zeros(n)
    e_src_vec[src] = 1.0
    for _ in range(max_iters):
        incoming = np.bincount(edst, weights=(rank * inv_out)[esrc],
                               minlength=n)
        new_rank = delta * incoming + (1.0 - delta) * e_src_vec
        diff = np.abs(new_rank - rank).sum()
        rank = new_rank
        if diff <= threshold:
            break

    # phase 2: circle of trust = top-k by PPR (ties -> lowest id, same
    # as lax.top_k), then in-degree restricted to CoT out-edges
    k = min(cot_size, n)
    cot = np.argsort(-rank, kind="stable")[:k]
    in_cot = np.zeros(n, bool)
    in_cot[cot] = True
    sel = in_cot[esrc]
    s, d = esrc[sel], edst[sel]
    cot_indeg = np.bincount(d, minlength=n).astype(np.float64)
    inv_cot_in = np.where(cot_indeg > 0,
                          1.0 / np.maximum(cot_indeg, 1.0), 0.0)

    # phase 3: personalized SALSA over the CoT's out-edges
    salsa_iters = int(1.0 / alpha)
    r = np.zeros(n)
    r[src] = 1.0
    ref = np.zeros(n)
    for _ in range(salsa_iters):
        ref = np.bincount(d, weights=(r * inv_out)[s], minlength=n)
        hub_val = np.where(s == src, alpha * inv_out[s], 0.0) + \
            (1.0 - alpha) * (ref * inv_cot_in)[d]
        r = np.bincount(s, weights=hub_val, minlength=n)
    return ref, rank


def cpu_hits(g, max_iters: int = 50):
    """HITS hub/authority scores (reference tests/hits)."""
    n = g.num_nodes
    src_of_edge = g.edge_sources()
    hub = np.ones(n)
    auth = np.ones(n)
    for _ in range(max_iters):
        auth = np.bincount(g.col_indices, weights=hub[src_of_edge],
                           minlength=n)
        hub = np.bincount(src_of_edge, weights=auth[g.col_indices],
                          minlength=n)
        auth /= max(auth.max(), 1e-12)
        hub /= max(hub.max(), 1e-12)
    return hub, auth
