"""CPU oracles for tests — re-exported from the package so the CLI and
the test-suite validate against the same reference implementations
(mirrors the reference keeping ReferenceBFS etc. inside each test binary,
``tests/bfs/test_bfs.cu:186-257``)."""

from gunrock_jax.utils.reference import (  # noqa: F401
    cpu_bfs, cpu_sssp, cpu_pagerank, cpu_cc, cpu_bc, cpu_hits,
    cpu_salsa, cpu_wtf,
)
