"""Thread-parallel host suite driver (the reference's batch-runner role).

The reference's bench layer runs suite instances as parallel PROCESSES
(`scripts/bench-lp/README.md:18-20`: emitted shell commands piped to
xargs/parallel.sh).  On host backends the same suite parallelism works
better in-process: XLA releases the GIL during compiled execution, so a
thread pool scales aggregate throughput across host cores while sharing
ONE jit cache (a process pool would pay a separate compile per worker).

Measured on the 4-core bench host (smoke-shape LPs, anchored mixed
precision): 13.7k ADMM it/s serial -> 34.6k aggregate with a pool,
~2.5x.  On an accelerator use the batched vmap drivers instead
(`parallel/batched.py`): one device runs one program at a time, and
batch parallelism belongs inside the program there.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp

from .batched import device_solve_lp

__all__ = ["pool_map", "solve_lp_pool"]


def pool_map(fn, items, workers: int | None = None):
    """Apply `fn` over `items` with a thread pool; returns a list.

    Worker exceptions propagate to the caller.  workers=None uses the
    host core count; workers=1 degenerates to a serial map.
    """
    workers = workers or os.cpu_count() or 1
    if workers == 1:
        return [fn(it) for it in items]
    with ThreadPoolExecutor(workers) as ex:
        return list(ex.map(fn, items))


def solve_lp_pool(problems, *, workers: int | None = None, **kw):
    """Solve a suite of standard-form LPs `(A, b, c)` concurrently.

    Each instance runs the full on-device solver (`device_solve_lp`)
    in its own pool thread; instances of the same shape share one
    compiled program.  The first instance of each distinct shape is
    solved up front (serially) so concurrent workers never race on a
    cold compile.  Returns a list of DeviceSolveResult in input order.
    """
    problems = [(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c))
                for A, b, c in problems]

    def solve(p):
        r = device_solve_lp(*p, **kw)
        jax.block_until_ready(r)
        return r

    # warm one instance per distinct shape to populate the jit cache
    seen = set()
    warm = {}
    for i, (A, _, _) in enumerate(problems):
        if A.shape not in seen:
            seen.add(A.shape)
            warm[i] = solve(problems[i])

    out = pool_map(solve, [p for i, p in enumerate(problems) if i not in warm],
                   workers)
    it = iter(out)
    return [warm[i] if i in warm else next(it) for i in range(len(problems))]
