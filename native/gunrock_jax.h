/**
 * gunrock_jax.h — C-callable simplified-array API.
 *
 * JAX rebuild of the reference's simplified C tier
 * (gunrock/gunrock.h:173-347: bfs/bc/cc/sssp/pagerank over raw CSR
 * arrays, consumed by shared_lib_tests/*.c). The implementation
 * (c_api.cpp) embeds CPython and delegates to gunrock_jax.capi, which
 * wraps the caller's buffers zero-copy and runs the JAX primitives; the
 * compute lands on whatever accelerator JAX is configured for.
 *
 * All functions return elapsed process time in milliseconds (the
 * reference's float return), or a negative value on failure.
 */
#ifndef GUNROCK_JAX_H
#define GUNROCK_JAX_H

#include <stdbool.h>

#ifdef __cplusplus
extern "C" {
#endif

/* BFS labels (hop counts; -1 unreachable). preds may be NULL unless
 * mark_predecessors. Reference: bfs(), gunrock.h:194-206. */
float gunrock_jax_bfs(int* bfs_label, int* bfs_pred, const int num_nodes,
                      const int num_edges, const int* row_offsets,
                      const int* col_indices, const int source,
                      const bool mark_predecessors,
                      const bool direction_optimized);

/* Betweenness centrality; source < 0 runs all-source (normalized like
 * the reference). Reference: bc(), gunrock.h:232-239. */
float gunrock_jax_bc(float* bc_scores, const int num_nodes,
                     const int num_edges, const int* row_offsets,
                     const int* col_indices, const int source);

/* Connected components; returns component count via out param.
 * Reference: cc(), gunrock.h:264-269. */
float gunrock_jax_cc(int* component, int* num_components,
                     const int num_nodes, const int num_edges,
                     const int* row_offsets, const int* col_indices);

/* SSSP distances (float32; +inf unreachable -> HUGE_VALF). preds may be
 * NULL unless mark_preds. Reference: sssp(), gunrock.h:304-314. */
float gunrock_jax_sssp(float* distances, int* preds, const int num_nodes,
                       const int num_edges, const int* row_offsets,
                       const int* col_indices, const float* edge_values,
                       const int source, const bool mark_preds);

/* PageRank: node_ids/pagerank sorted by rank descending, top num_nodes
 * entries. Reference: pagerank(), gunrock.h:341-347. */
float gunrock_jax_pagerank(int* node_ids, float* pagerank,
                           const int num_nodes, const int num_edges,
                           const int* row_offsets, const int* col_indices,
                           const bool normalized);

#ifdef __cplusplus
}
#endif

#endif /* GUNROCK_JAX_H */
