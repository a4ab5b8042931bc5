"""Published reference baselines for honest bench ratios.

Bench records carry one ratio:

* ``vs_reference_row`` — the NEAREST published row of the reference's
  own K40c table (``/root/reference/doc/stats/engines_topc.md``, copied
  into BASELINE.md), picked by primitive + graph class. The reference's
  DOBFS rows use idempotent direction-optimized TEPS accounting (edge
  *inspections*, ``util/info.cuh:1431`` with DO search — 122 GTEPS on a
  288 GB/s K40c is far above its gather bandwidth), so BFS ratios
  across accounting schemes are apples-to-oranges; they are emitted
  anyway to keep the pressure honest, with the row named inline.
"""

from __future__ import annotations

from typing import Optional, Tuple

__all__ = ["reference_row", "annotate"]

# (primitive, graph_class) -> (row label, MTEPS on Tesla K40c)
_ROWS = {
    ("bfs", "scalefree"): ("bfs_do rmat_n22_e64 K40c (DO-TEPS accounting)",
                           122516.0),
    ("bfs", "meshy"): ("bfs_do road_usa K40c", 85.3),
    ("sssp", "scalefree"): ("sssp soc-orkut K40c", 216.7),
    ("sssp", "meshy"): ("sssp road_usa K40c", 5.2),
    ("pr", "scalefree"): ("pagerank soc-orkut K40c (per-iter)", 1228.0),
    ("pr", "meshy"): ("pagerank road_usa K40c (per-iter)", 2394.0),
    ("cc", "scalefree"): ("cc soc-orkut K40c", 1005.0),
    ("cc", "meshy"): ("cc road_usa K40c", 276.0),
    ("bc", "scalefree"): ("bc soc-orkut K40c", 1070.0),
    ("bc", "meshy"): ("bc road_usa K40c", 95.9),
}


def reference_row(primitive: str,
                  graph_kind: str) -> Optional[Tuple[str, float]]:
    """Nearest published K40c row for (primitive, graph kind).

    ``graph_kind`` is the bench generator kind (rmat/market = scale-free;
    grid/rgg = meshy/road-class). Returns None for primitives the
    reference never published (HITS/SALSA/WTF/TopK/TC).
    """
    klass = "meshy" if graph_kind in ("grid", "rgg", "meshy") \
        else "scalefree"
    return _ROWS.get((primitive, klass))


def annotate(rec: dict, primitive: str, graph_kind: str,
             mteps: float) -> dict:
    """Add vs_reference_row fields to a bench record in place."""
    row = reference_row(primitive, graph_kind)
    if row is not None:
        rec["reference_row"] = row[0]
        rec["reference_row_mteps"] = row[1]
        rec["vs_reference_row"] = round(mteps / row[1], 4)
    return rec
