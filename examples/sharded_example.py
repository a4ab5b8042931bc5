"""Multi-chip demo: the sharded zoo over a device mesh.

Partitions one graph across every visible device (GPUs joined by NVLink
in production; set the env below to demo on an 8-device virtual CPU mesh —
the reference's ``--device=0,0`` fake-multi-GPU trick,
``CMakeLists.txt:389-421``), then runs sharded BFS / PageRank / CC and
cross-checks each against its single-chip result.

Run (no GPUs needed):

  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python examples/sharded_example.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import gunrock_jax as gt
from gunrock_jax.parallel import bfs_sharded, cc_sharded, pagerank_sharded


def main():
    import jax
    p = len(jax.devices())
    g = gt.io.rmat(scale=12, edge_factor=16, seed=0, undirected=True)
    src = int(g.largest_degree_vertex())
    print(f"graph: |V|={g.num_nodes} |E|={g.num_edges}; "
          f"mesh: {p}x {jax.devices()[0].platform}")

    # Sharded direction-optimized BFS: per-shard advance, boundary-only
    # exchange, psum termination — one compiled superstep loop.
    rb = bfs_sharded(g, src=src, num_shards=p, direction_optimized=True)
    single = gt.bfs(g, src=src, direction_optimized=True)
    assert (rb.labels == single.labels).all(), "sharded BFS diverged"
    print(f"bfs:  depth={rb.labels.max()}  "
          f"comm={rb.info['comm_bytes'] / 1024:.1f} KiB  "
          f"[matches single-chip bitwise]")

    # Sharded PageRank: pull-SpMV per shard, ghost exchange per round.
    rp = pagerank_sharded(g, num_shards=p, max_iters=30)
    sp = gt.pagerank(g, max_iters=30)
    top_match = set(map(int, rp.node_ids[:10])) == \
        set(map(int, sp.node_ids[:10]))
    print(f"pr:   top vertex={int(rp.node_ids[0])}  "
          f"[top-10 {'matches' if top_match else 'DIFFERS from'} "
          f"single-chip]")

    # Sharded connected components: local hook/collapse + periodic
    # global collapse rungs.
    rc = cc_sharded(g, num_shards=p)
    sc = gt.cc(g)
    assert rc.num_components == sc.num_components, "sharded CC diverged"
    print(f"cc:   {rc.num_components} components  [matches single-chip]")


if __name__ == "__main__":
    main()
