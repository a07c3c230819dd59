"""Parametric serving: one factorization, many solves.

The reference splits `ABIP(init)`/`ABIP(solve)` so one factorization
serves repeated solves with new data (`include/abip.h:116-123`); here
that is `LPWorkspace.update_problem(b, c)` -- the cached Cholesky
factor AND the compiled kernels persist across ticks.  A drifting-
demand LP family is re-solved each "tick" with a warm seed from the
previous optimum.

Note the measured reality (DESIGN.md): warm seeds do NOT shorten the
IPM mu path for this method (skipping stages makes the ADMM inner
subproblems harder -- a recorded negative result), so the per-tick win
comes from setup reuse and slightly easier stages, not from a shorter
path.
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
if os.environ.get("ABIP_CPU", "1") != "0":  # CPU default; ABIP_CPU=0 for the GPU
    import jax

    jax.config.update("jax_platforms", "cpu")
import numpy as np

import abip
from abip.lp import LPWorkspace

rng = np.random.default_rng(0)
m, n = 40, 400
A = np.concatenate(
    [rng.standard_normal((m, n - m)) * (rng.random((m, n - m)) < 0.3),
     np.eye(m)], axis=1)
b0 = A @ (rng.random(n) + 0.5)
c = A.T @ rng.standard_normal(m) + rng.random(n) + 0.5
TICKS = 10

w = LPWorkspace(A, b0, c, abip.Settings(eps=1e-6, adaptive=False))
prev = w.solve()
w.update_problem(b0 * 1.001, c)   # absorb the one-off compile off-clock
w.solve(warm=(prev.x, prev.y, prev.s))

t0 = time.perf_counter()
for k in range(TICKS):
    b_k = b0 * (1.0 + 0.02 * np.sin(0.3 * (k + 1)))
    w.update_problem(b_k, c)
    prev = w.solve(warm=(prev.x, prev.y, prev.s))
    assert prev.status_name == "Solved"
served = (time.perf_counter() - t0) / TICKS

t0 = time.perf_counter()
for k in range(TICKS):
    b_k = b0 * (1.0 + 0.02 * np.sin(0.3 * (k + 1)))
    s_k = abip.solve_lp(A, b_k, c, eps=1e-6, adaptive=False)
    assert s_k.status_name == "Solved"
cold = (time.perf_counter() - t0) / TICKS

print(f"per-tick latency: served (factor reuse + warm) {served * 1e3:.0f}ms"
      f" vs from-scratch {cold * 1e3:.0f}ms -> {cold / served:.2f}x")
