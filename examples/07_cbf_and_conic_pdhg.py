"""Native CBLIB .cbf IO + the conic restarted-PDHG competitor.

Round-trips a conic problem through CBF text, solves it with both the
ADMM interior-point driver and the first-order PDHG competitor, and
checks the two against the construction's known optimum.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
if os.environ.get("ABIP_CPU", "1") != "0":  # CPU default; ABIP_CPU=0 for the GPU
    import jax

    jax.config.update("jax_platforms", "cpu")
import numpy as np  # noqa: F401

from abip import ConeSpec, solve_qcp_pdhg
from abip.io.cbf import solve_cbf, write_cbf
from benchmarks.conic_mini import randcone

name, A, b, c, cones, pobj_star = randcone(
    "demo", 12, ConeSpec(soc=(6,), rsoc=(4,), nonneg=14), seed=1)

write_cbf("/tmp/demo.cbf", A, b, c, cones, comment="example instance")
sol, x, obj = solve_cbf("/tmp/demo.cbf", eps=1e-7)
print(f"ADMM via .cbf : {sol.status_name}, obj {obj:.8f} "
      f"(star {pobj_star:.8f})")

pd = solve_qcp_pdhg(A, b, c, cones, eps=1e-7)
print(f"conic PDHG    : {pd.status_name}, obj {pd.pobj:.8f} "
      f"in {pd.admm_iters} iterations")
assert abs(obj - pobj_star) < 1e-5 and abs(pd.pobj - pobj_star) < 1e-5
