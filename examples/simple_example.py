"""Composition demo: CC -> BFS -> BC on one graph.

JAX rebuild of the reference's ``simple_example/simple_example.cu``
(1921 LoC of CUDA driver): find connected components, BFS from the
largest-degree vertex of the largest component, then single-source BC
from the same vertex — sharing one loaded graph across primitives.

Run:  python examples/simple_example.py [path/to/graph.mtx]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import gunrock_jax as gt

DEFAULT = "/root/reference/simple_example/bips98_606.mtx"


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else DEFAULT
    if os.path.exists(path):
        g = gt.io.load_market(path, undirected=True, use_cache=False)
    else:
        print(f"{path} not found; generating R-MAT")
        g = gt.io.rmat(scale=12, edge_factor=16, seed=0, undirected=True)
    print(f"graph: |V|={g.num_nodes} |E|={g.num_edges}")

    # 1. connected components
    cc = gt.cc(g)
    print(f"cc: {cc.num_components} components "
          f"({cc.info['process_ms']:.1f} ms)")
    comp_sizes = np.bincount(cc.components)
    biggest = int(np.argmax(comp_sizes))
    print(f"   largest component: {comp_sizes[biggest]} vertices")

    # 2. BFS from the largest-degree vertex inside the largest component
    deg = g.out_degrees.copy()
    deg[cc.components != biggest] = -1
    src = int(np.argmax(deg))
    bfs = gt.bfs(g, src, mark_preds=True, direction_optimized=True)
    print(f"bfs: src={src} depth={bfs.info['search_depth']} "
          f"reached={(bfs.labels >= 0).sum()} "
          f"({bfs.info['process_ms']:.1f} ms, "
          f"{bfs.info.get('m_teps', 0):.1f} MTEPS)")

    # 3. betweenness centrality from the same source
    bc = gt.bc(g, src)
    top = np.argsort(-bc.bc_values)[:5]
    print(f"bc: top-5 central vertices {top.tolist()} "
          f"({bc.info['process_ms']:.1f} ms)")


if __name__ == "__main__":
    main()
