"""Restarted PDHG (the PDLP-style first-order competitor) on a random LP.

The reference benchmarks ABIP against Google's PDLP via an external
driver (`scripts/bench-lp/pdlp_solve.py`); abip ships the method
natively.  Same standard form as `solve_lp`, one jitted while_loop,
`precision="mixed"` for the anchored-f32 hot loop.

Run: python examples/05_pdhg.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

if os.environ.get("ABIP_CPU", "1") != "0":  # CPU default; ABIP_CPU=0 for the GPU
    import jax

    jax.config.update("jax_platforms", "cpu")
import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")  # example runs anywhere

import abip  # noqa: E402

rng = np.random.default_rng(0)
m, n = 50, 200
A = rng.standard_normal((m, n))
b = A @ (rng.random(n) + 0.5)
c = A.T @ rng.standard_normal(m) + rng.random(n) + 0.5

sol = abip.solve_lp_pdhg(A, b, c, eps=1e-6, precision="mixed")
print(f"PDHG : {sol.status_name} in {sol.admm_iters} iterations, "
      f"pobj={sol.pobj:.8f}")

ref = abip.solve_lp(A, b, c, eps=1e-6)
print(f"ABIP : {ref.status_name} in {ref.admm_iters} ADMM iterations, "
      f"pobj={ref.pobj:.8f}")
print(f"objective agreement: {abs(sol.pobj - ref.pobj):.2e}")
