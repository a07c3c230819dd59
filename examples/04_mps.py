"""Solve an MPS file end-to-end (general form -> standard form -> solve)."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

if os.environ.get("ABIP_CPU", "1") != "0":  # CPU default; ABIP_CPU=0 for the GPU
    import jax

    jax.config.update("jax_platforms", "cpu")
import sys

from abip.io.presolve import solve_mps

DEFAULT = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                       "suites", "netlib_mini", "blend01.mps")
path = sys.argv[1] if len(sys.argv) > 1 else DEFAULT
sol, std = solve_mps(path, eps=1e-6)
print(f"{sol.status_name}: objective {sol.pobj:.8f} "
      f"({sol.ipm_iters} IPM / {sol.admm_iters} ADMM iterations)")
