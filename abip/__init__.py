"""ABIP: an ADMM-based interior point solver framework in JAX.

A ground-up JAX/XLA re-design with the capabilities of the reference
ABIP solver (leavesgrp/ABIP): LP and conic/QP solving via an outer
interior-point path-following loop around an inner ADMM loop on the
homogeneous self-dual embedding.

Quick start::

    import abip
    sol = abip.solve_lp(A, b, c, eps=1e-6)

The solver needs float64; importing this package enables JAX x64 mode
(set ABIP_NO_X64=1 to opt out and manage precision yourself).
"""
import os

import jax

if not os.environ.get("ABIP_NO_X64"):
    jax.config.update("jax_enable_x64", True)

if not os.environ.get("ABIP_NO_HIGHEST_MATMUL"):
    # On the GPU an f32 matmul at DEFAULT precision may run in TF32,
    # which keeps ~3 decimal digits.  Every f32 matmul in this package is
    # an anchored-delta or preconditioner apply whose error budget
    # assumes true-f32 accuracy (~1e-7), so f32 products stay f32.  No
    # effect on f64 ops.
    jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache: where JAX_COMPILATION_CACHE_DIR points
# (JAX reads it itself), else one fixed directory inside the checkout,
# so compiles survive across processes and the path -- part of the
# cache key -- never moves.
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), ".jax_cache"))

from .settings import Settings, Status          # noqa: E402
from .dispatch import solve, solve_general      # noqa: E402
from .problem import LinearOperator             # noqa: E402
from .lp import solve_lp, LPWorkspace, LPSolution  # noqa: E402
from .cones import ConeSpec                     # noqa: E402
from .qcp import solve_qcp, ConicWorkspace, ConicSolution, conic_defaults  # noqa: E402
from .pdhg import solve_lp_pdhg, solve_qcp_pdhg  # noqa: E402
from .diff import (solve_lp_grad, solve_qcp_grad, solve_lasso_grad,  # noqa: E402
                   solve_svm_grad)

__version__ = "0.1.0"

__all__ = [
    "solve",
    "solve_general",
    "Settings",
    "Status",
    "LinearOperator",
    "ConeSpec",
    "solve_lp",
    "LPWorkspace",
    "LPSolution",
    "solve_qcp",
    "ConicWorkspace",
    "ConicSolution",
    "conic_defaults",
    "solve_lp_pdhg",
    "solve_qcp_pdhg",
    "solve_lp_grad",
    "solve_qcp_grad",
    "solve_lasso_grad",
    "solve_svm_grad",
    "__version__",
]
