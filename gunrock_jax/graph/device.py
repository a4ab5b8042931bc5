"""Device-resident graph: padded, static-shape, int32 CSR for XLA.

JAX replacement for the reference's ``GraphSlice``
(``gunrock/app/problem_base.cuh:85-342``): the per-device graph holds the
forward CSR, optionally the inverse CSR (CSC) for pull/backward primitives,
and per-edge values. Where the reference relies on dynamic allocation
(``util/array_utils.cuh`` Array1D EnsureSize), we pad every array to a
static capacity once at load time — XLA requires static shapes, and a
coarse padding granule keeps the number of distinct compiled shapes
small.

Padding invariants:
  * ``row_offsets`` has ``v_pad + 1`` entries; entries past ``num_nodes``
    repeat ``num_edges`` so padded vertices have degree 0.
  * ``col_indices`` / ``edge_values`` are padded to ``e_pad``; padded edges
    point at vertex 0 but are never reachable via offsets (their source has
    degree 0). Per-edge segment-id arrays (``edge_src`` / ``csc_edge_dst``)
    use ``v_pad`` as the fill so segment ops sized ``v_pad`` drop them.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .csr import CsrGraph

__all__ = ["DeviceGraph", "to_device", "round_up"]

LANE = 128  # padding granule for vertex and edge arrays


def round_up(x: int, m: int = LANE) -> int:
    return ((x + m - 1) // m) * m


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "row_offsets", "col_indices", "edge_values", "edge_src",
        "csc_offsets", "csc_indices", "csc_edge_values", "csc_edge_dst",
    ],
    meta_fields=["num_nodes", "num_edges", "v_pad", "e_pad", "undirected"],
)
@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """Static-shape CSR (+ optional CSC) living in HBM.

    ``num_nodes``/``num_edges`` are Python ints (static under jit);
    dynamic per-run state (frontiers, labels) lives in the per-primitive
    problem state, mirroring the reference's GraphSlice/DataSlice split
    (``problem_base.cuh:85,357``).
    """

    num_nodes: int
    num_edges: int
    v_pad: int
    e_pad: int
    row_offsets: jax.Array                 # (v_pad+1,) int32
    col_indices: jax.Array                 # (e_pad,)   int32
    edge_values: Optional[jax.Array]       # (e_pad,)   float32 or None
    # Per-CSR-edge source vertex (COO rows): segment/source ids for
    # full-edge-list ("ALL_EDGES") advance, reference
    # ``oprtr/all_edges_advance/`` used by CC (``app/cc/cc_enactor.cuh:343``).
    edge_src: Optional[jax.Array]          # (e_pad,)   int32, fill v_pad
    # Inverse CSR (reference GraphSlice column_offsets/row_indices,
    # problem_base.cuh:97-98) for pull-mode advance / backward BC.
    # csc row v lists the *in*-neighbors (sources) of v.
    csc_offsets: Optional[jax.Array]       # (v_pad+1,) int32
    csc_indices: Optional[jax.Array]       # (e_pad,)   int32 (source u per in-edge)
    csc_edge_values: Optional[jax.Array]   # (e_pad,)   float32
    csc_edge_dst: Optional[jax.Array]      # (e_pad,)   int32 (dest v per in-edge, fill v_pad)
    # Symmetric edge set (built with undirected=True).
    undirected: bool = False

    @property
    def has_csc(self) -> bool:
        return self.csc_offsets is not None

    @property
    def has_edge_values(self) -> bool:
        return self.edge_values is not None

    def out_degree(self, v: jax.Array) -> jax.Array:
        return self.row_offsets[v + 1] - self.row_offsets[v]

    def in_degree(self, v: jax.Array) -> jax.Array:
        return self.csc_offsets[v + 1] - self.csc_offsets[v]


def _pad_offsets(row_offsets: np.ndarray, v_pad: int, num_edges: int,
                 dtype=np.int32) -> np.ndarray:
    out = np.full(v_pad + 1, num_edges, dtype=dtype)
    out[: row_offsets.shape[0]] = row_offsets.astype(dtype)
    return out


def _pad_edges(arr: np.ndarray, e_pad: int, fill) -> np.ndarray:
    out = np.full(e_pad, fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def _edge_seg_ids(row_offsets: np.ndarray, num_nodes: int, e_pad: int,
                  v_pad: int) -> np.ndarray:
    seg = np.repeat(np.arange(num_nodes, dtype=np.int32), np.diff(row_offsets))
    return _pad_edges(seg, e_pad, v_pad)


def to_device(
    g: CsrGraph,
    *,
    with_csc: bool = False,
    with_edge_values: bool = False,
    with_edge_src: bool = False,
    sizet64: Optional[bool] = None,
) -> DeviceGraph:
    """Upload a host CSR to the device, padded to ``LANE`` multiples.

    Equivalent role to ``GraphSlice::Init`` H2D copies
    (``problem_base.cuh:192-310``).

    ``sizet64``: hold edge offsets as int64 (the reference's
    ``--64bit-SizeT``, ``util/test_utils.h``); auto-enabled past 2^31-2
    edges. Offset arithmetic in the XLA operators follows the dtype.
    """
    v_pad = round_up(max(g.num_nodes, 1))
    e_pad = round_up(max(g.num_edges, 1))
    if sizet64 is None:
        sizet64 = e_pad >= 2**31 - 2
    if sizet64 and not jax.config.jax_enable_x64:
        raise ValueError("sizet64 needs JAX x64 mode: set JAX_ENABLE_X64=1 "
                         "or jax.config.update('jax_enable_x64', True)")
    off_t = np.int64 if sizet64 else np.int32

    row = _pad_offsets(g.row_offsets, v_pad, g.num_edges, off_t)
    col = _pad_edges(g.col_indices.astype(np.int32), e_pad, 0)

    ev = None
    if with_edge_values:
        vals = g.edge_values
        if vals is None:
            vals = np.ones(g.num_edges, dtype=np.float32)
        ev = jnp.asarray(_pad_edges(vals.astype(np.float32), e_pad, 0.0))

    edge_src = None
    if with_edge_src:
        edge_src = jnp.asarray(_edge_seg_ids(g.row_offsets, g.num_nodes, e_pad, v_pad))

    csc_off = csc_idx = csc_ev = csc_dst = None
    if with_csc:
        t = g.csc()
        csc_off = jnp.asarray(_pad_offsets(t.row_offsets, v_pad,
                                           t.num_edges, off_t))
        csc_idx = jnp.asarray(_pad_edges(t.col_indices.astype(np.int32), e_pad, 0))
        if with_edge_values:
            tv = t.edge_values
            if tv is None:
                tv = np.ones(t.num_edges, dtype=np.float32)
            csc_ev = jnp.asarray(_pad_edges(tv.astype(np.float32), e_pad, 0.0))
        csc_dst = jnp.asarray(_edge_seg_ids(t.row_offsets, t.num_nodes, e_pad, v_pad))

    return DeviceGraph(
        num_nodes=g.num_nodes,
        num_edges=g.num_edges,
        v_pad=v_pad,
        e_pad=e_pad,
        row_offsets=jnp.asarray(row),
        col_indices=jnp.asarray(col),
        edge_values=ev,
        edge_src=edge_src,
        csc_offsets=csc_off,
        csc_indices=csc_idx,
        csc_edge_values=csc_ev,
        csc_edge_dst=csc_dst,
        undirected=bool(getattr(g, "undirected", False)),
    )
