"""Profiling hooks: jax.profiler integration.

Device-era replacement for the reference's DEBUG_FUNC entry/exit tracing
(`include/glbopts.h:144-155`) and hand-rolled timers: named traces around
the solver phases, viewable in Perfetto/TensorBoard.
"""
from __future__ import annotations

import contextlib

import jax


def annotate(name: str):
    """Named-scope annotation usable as decorator or context manager."""
    return jax.profiler.TraceAnnotation(name)


@contextlib.contextmanager
def trace_solve(log_dir: str):
    """Capture a device trace of everything inside the context.

    Usage::
        with trace_solve("/tmp/abip-trace"):
            abip.solve_lp(A, b, c)
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
