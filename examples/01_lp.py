"""Basic LP: min c'x s.t. Ax = b, x >= 0."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

if os.environ.get("ABIP_CPU", "1") != "0":  # CPU default; ABIP_CPU=0 for the GPU
    import jax

    jax.config.update("jax_platforms", "cpu")
import numpy as np

import abip

rng = np.random.default_rng(0)
m, n = 30, 120
A = rng.standard_normal((m, n))
b = A @ (rng.random(n) + 0.5)           # feasible by construction
c = A.T @ rng.standard_normal(m) + rng.random(n) + 0.5

sol = abip.solve_lp(A, b, c, eps=1e-6, verbose=True)
print(f"\n{sol.status_name}: pobj={sol.pobj:.6f} in "
      f"{sol.ipm_iters} IPM / {sol.admm_iters} ADMM iterations")
