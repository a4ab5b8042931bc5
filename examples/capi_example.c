/* C consumer of the gunrock_jax simplified-array ABI.
 *
 * JAX-framework analogue of the reference's shared-library consumers
 * (shared_lib_tests/shared_lib_bfs.c, simple_example.c): build a small
 * CSR graph in plain C arrays, run CC -> BFS -> SSSP -> PageRank
 * through the C ABI (native/gunrock_jax.h), print and sanity-check the
 * results.
 *
 * Build (tests/test_capi.py does this automatically):
 *   gcc capi_example.c -o capi_example -I../native \
 *       -L../native -lgunrock_jax -Wl,-rpath,$PWD/../native
 */
#include <math.h>
#include <stdio.h>
#include <stdlib.h>

#include "gunrock_jax.h"

int main(void) {
  /* Two triangles bridged by one edge, plus an isolated vertex:
   *   0-1-2-0   3-4-5-3   2-3   6          (undirected -> both dirs) */
  int row_offsets[] = {0, 2, 4, 7, 10, 12, 14, 14};
  int col_indices[] = {1, 2, 0, 2, 0, 1, 3, 2, 4, 5, 3, 5, 3, 4};
  float edge_values[] = {1, 4, 1, 1, 4, 1, 2, 2, 1, 4, 1, 1, 4, 1};
  const int num_nodes = 7;
  const int num_edges = 14;

  int component[7], num_components = 0;
  float t = gunrock_jax_cc(component, &num_components, num_nodes,
                           num_edges, row_offsets, col_indices);
  if (t < 0) { fprintf(stderr, "cc failed\n"); return 1; }
  printf("cc: %d components (%.2f ms):", num_components, t);
  for (int i = 0; i < num_nodes; ++i) printf(" %d", component[i]);
  printf("\n");
  if (num_components != 2) { fprintf(stderr, "BAD cc count\n"); return 1; }

  int label[7], pred[7];
  t = gunrock_jax_bfs(label, pred, num_nodes, num_edges, row_offsets,
                      col_indices, /*source=*/0,
                      /*mark_predecessors=*/true,
                      /*direction_optimized=*/false);
  if (t < 0) { fprintf(stderr, "bfs failed\n"); return 1; }
  printf("bfs: labels (%.2f ms):", t);
  for (int i = 0; i < num_nodes; ++i) printf(" %d", label[i]);
  printf("\n");
  int expect_label[] = {0, 1, 1, 2, 3, 3, -1};
  for (int i = 0; i < num_nodes; ++i)
    if (label[i] != expect_label[i]) {
      fprintf(stderr, "BAD bfs label[%d]=%d\n", i, label[i]);
      return 1;
    }

  float dist[7];
  t = gunrock_jax_sssp(dist, pred, num_nodes, num_edges, row_offsets,
                       col_indices, edge_values, /*source=*/0,
                       /*mark_preds=*/true);
  if (t < 0) { fprintf(stderr, "sssp failed\n"); return 1; }
  printf("sssp: distances (%.2f ms):", t);
  for (int i = 0; i < num_nodes; ++i) printf(" %.1f", dist[i]);
  printf("\n");
  float expect_dist[] = {0, 1, 2, 4, 5, 6, HUGE_VALF};
  for (int i = 0; i < num_nodes; ++i)
    if (fabsf(dist[i] - expect_dist[i]) > 1e-4f &&
        !(isinf(dist[i]) && isinf(expect_dist[i]))) {
      fprintf(stderr, "BAD sssp dist[%d]=%f\n", i, dist[i]);
      return 1;
    }

  int node_ids[7];
  float ranks[7];
  t = gunrock_jax_pagerank(node_ids, ranks, num_nodes, num_edges,
                           row_offsets, col_indices,
                           /*normalized=*/true);
  if (t < 0) { fprintf(stderr, "pagerank failed\n"); return 1; }
  printf("pagerank: top node %d rank %.4f (%.2f ms)\n", node_ids[0],
         ranks[0], t);
  for (int i = 1; i < num_nodes; ++i)
    if (ranks[i] > ranks[i - 1] + 1e-6f) {
      fprintf(stderr, "BAD pagerank order at %d\n", i);
      return 1;
    }

  printf("capi_example: ALL OK\n");
  return 0;
}
