"""Enactor: the BSP superstep driver shared by all primitives.

The reference's enactor layer (``gunrock/app/enactor_{base,loop}.cuh``) is a
pthread-per-GPU software pipeline; under XLA the whole superstep loop
compiles into a single ``lax.while_loop`` with no host round-trips, so the
"enactor" collapses to: a loop-state convention, device-side statistics
accumulation (reference ``EnactorStats``, ``enactor_types.cuh:50-194``),
and a capacity-ladder kernel dispatch (the analogue of the reference's
LB / LB_LIGHT kernel selection by frontier size,
``oprtr/advance/kernel_policy.cuh`` LIGHT_EDGE_THRESHOLD).
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Any, Callable, Sequence

import jax
import jax.numpy as jnp

__all__ = ["LoopStats", "init_stats", "record_iteration", "reset_chunk",
           "capacity_ladder", "dispatch_by_size", "Timer"]

# Per-iteration frontier-size trace length (reference Info records
# per-iteration queue lengths, ``util/info.cuh:684-709``).
TRACE_LEN = 2048


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["iteration", "nodes_queued", "edges_queued", "chunk_edges",
                 "overflow", "frontier_trace"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class LoopStats:
    """Device-side running statistics (reference EnactorStats:
    ``iteration``, ``nodes_queued``/``edges_queued`` accumulators,
    ``enactor_types.cuh:50-80``)."""

    iteration: jax.Array       # () int32
    nodes_queued: jax.Array    # () float32 (display counter; exact totals
    edges_queued: jax.Array    # () float32  are recomputed host-side)
    chunk_edges: jax.Array     # () int32 — exact edge-lane count since the
    #                              host last reset it (reset_chunk); the
    #                              per-chunk device-time budget compares
    #                              against this, NOT the float display
    #                              accumulator (which absorbs small
    #                              increments past 2^24 cumulative lanes)
    overflow: jax.Array        # () bool — a frontier exceeded its capacity
    frontier_trace: jax.Array  # (TRACE_LEN,) int32


def i32_clip(x):
    """Clip to int32 (stats/dispatch values) — keeps loop-state dtypes
    stable when offsets are int64 (--64bit-SizeT)."""
    import jax.numpy as jnp
    return jnp.minimum(x, 2**31 - 1).astype(jnp.int32)


def init_stats() -> LoopStats:
    return LoopStats(
        iteration=jnp.int32(0),
        nodes_queued=jnp.float32(0),
        edges_queued=jnp.float32(0),
        chunk_edges=jnp.int32(0),
        overflow=jnp.bool_(False),
        frontier_trace=jnp.full((TRACE_LEN,), -1, jnp.int32),
    )


def reset_chunk(stats: LoopStats) -> LoopStats:
    """Host-side per-chunk budget reset: zero the exact chunk edge
    counter before each chunked device call (keeps the budget compare
    in small exact integers regardless of cumulative totals)."""
    return dataclasses.replace(stats, chunk_edges=jnp.int32(0))


def record_iteration(stats: LoopStats, *, frontier_len: jax.Array,
                     edges: jax.Array, overflow=None) -> LoopStats:
    slot = jnp.minimum(stats.iteration, TRACE_LEN - 1)
    # Saturating int32 chunk accumulator: increments clip to 2^29 and the
    # running value to 2^30, so the add can never wrap and any budget
    # <= 2^29 still trips exactly.
    inc = jnp.minimum(edges.astype(jnp.int32), jnp.int32(1 << 29))
    return LoopStats(
        iteration=stats.iteration + 1,
        nodes_queued=stats.nodes_queued + frontier_len.astype(jnp.float32),
        edges_queued=stats.edges_queued + edges.astype(jnp.float32),
        chunk_edges=jnp.minimum(stats.chunk_edges + inc,
                                jnp.int32(1 << 30)),
        overflow=stats.overflow | (jnp.bool_(False) if overflow is None
                                   else overflow),
        frontier_trace=stats.frontier_trace.at[slot].set(
            frontier_len.astype(jnp.int32)),
    )


def frontier_ladder(cap: int, *, base: int = 4096,
                    step: int = 8) -> list[int]:
    """Input-side (frontier-width) rung ladder: the smallest rung >= n
    bounds the frontier-scale scatters/gathers of a round. Shared by the
    advance front-end (``ops/advance._expand_csr``) and the SSSP queue
    degree-sum (``models/sssp._laddered_mf``) so the two paths can never
    diverge on base/step tuning. Delegates to :func:`capacity_ladder` —
    same rungs, input-side framing."""
    return capacity_ladder(cap, base=base, step=step)


def capacity_ladder(max_cap: int, *, base: int = 4096,
                    step: int = 8) -> list[int]:
    """Geometric ladder of advance-output capacities up to ``max_cap``.

    Small frontiers run the small-capacity compilation of the superstep —
    the equivalent of the reference dispatching RelaxLightEdges vs
    RelaxPartitionedEdges2 by frontier size
    (``oprtr/edge_map_partitioned/kernel.cuh:185,355``).
    """
    caps: list[int] = []
    c = base
    while c < max_cap:
        caps.append(c)
        c *= step
    caps.append(max_cap)
    return caps


def dispatch_by_size(size: jax.Array, caps: Sequence[int],
                     make_branch: Callable[[int], Callable[[Any], Any]],
                     operand: Any) -> Any:
    """``lax.switch`` over ladder rungs: run ``make_branch(cap)`` for the
    smallest cap >= size (last rung if none). All branches must return
    identically shaped pytrees."""
    caps = list(caps)
    if len(caps) == 1:
        return make_branch(caps[0])(operand)
    bounds = jnp.asarray(caps[:-1], dtype=size.dtype)
    # compare-sum over a handful of bounds: one fused elementwise op.
    idx = jnp.sum((size > bounds).astype(jnp.int32))
    return jax.lax.switch(idx, [make_branch(c) for c in caps], operand)


class Timer:
    """Wall-clock timing split matching the reference's Info record
    (load / preprocess / process / postprocess, ``util/info.cuh``)."""

    def __init__(self) -> None:
        self.splits: dict[str, float] = {}

    def time(self, name: str):
        timer = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()

            def __exit__(self, *exc):
                timer.splits[name] = timer.splits.get(name, 0.0) + (
                    time.perf_counter() - self.t0)

        return _Ctx()
