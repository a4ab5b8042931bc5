"""Debug/forensics utilities.

JAX rebuild of the reference's homegrown race-forensics toolkit:

  * ``TO_TRACK`` vertex watchlists that print every state change of
    chosen vertices (``util/track_utils.cuh:22-110``)
  * synthetic latency injection for scalability studies
    (``util/latency_utils.cuh:20-80``, enactor knobs
    ``--communicate-latency`` etc., ``enactor_base.cuh:72-77``)

There are no data races to chase (scatters and segment reductions are
whole-array XLA ops), so tracking reduces to observability: a jit-friendly
tap that reports tracked vertices' values per iteration via
``jax.debug.print``, and a calibrated compute-burn for emulating slower
interconnects inside compiled supersteps.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

__all__ = ["track_values", "inject_latency"]


def track_values(name: str, values: jax.Array,
                 vertices: Sequence[int], iteration=None) -> None:
    """Print tracked vertices' current values from inside jit.

    Reference ``Check_Value/Track_Results`` (``util/track_utils.cuh``):
    call inside a primitive's iteration body; prints via the host callback
    only when the watchlist is non-empty, so production runs pay nothing.
    """
    if not vertices:
        return
    verts = jnp.asarray(list(vertices), dtype=jnp.int32)
    vals = values[verts]
    if iteration is None:
        jax.debug.print(name + " verts={v} values={x}", v=verts, x=vals)
    else:
        jax.debug.print(name + " iter={i} verts={v} values={x}",
                        i=iteration, v=verts, x=vals)


def inject_latency(x: jax.Array, rounds: int) -> jax.Array:
    """Burn ~``rounds`` dependent elementwise passes over ``x`` and return
    it unchanged (bit-exact). The analogue of the reference's busy-spin
    latency kernels (``util/latency_utils.cuh``): emulates a slower
    interconnect/stage inside a compiled superstep for scalability
    modeling. ``rounds=0`` is a no-op with zero cost.
    """
    if rounds <= 0:
        return x
    # A dependent LCG chain the compiler cannot shorten, fenced with
    # optimization_barrier so neither the burn nor x gets DCE'd/reordered.
    def body(_, v):
        return (v * 1664525 + 1013904223) ^ (v >> 1)
    seed = jnp.full((8, 128), 12345, jnp.int32)
    burn = jax.lax.fori_loop(0, rounds, body, seed)
    x, _ = jax.lax.optimization_barrier((x, burn))
    return x
