"""Linear-system layer: pluggable KKT solvers for the ADMM projection step.

JAX re-design of the reference's linsys seam
(`/root/reference/src/abip-lp/include/linsys.h:10-25`,
`/root/reference/src/abip-qcp/source/linsys.c:1027-1176`).

Every backend solves the quasi-definite KKT system

    K z = w,     K = [[rho_y * I,  A ],
                      [A^T,       -I ]]

eliminated to the normal equations (the reference's `indirect.c:205-220`
derivation, which is also the batch-friendly dense form):

    (rho_y * I + A A^T) z_y = w_y + A w_x
    z_x = A^T z_y - w_x

Backends:
  * dense  -- Cholesky of the m x m normal matrix, factored ONCE per solve
              (the defining economy of ABIP: the reference factors its KKT
              once in `direct.c:218-270` and reuses it every ADMM iteration).
  * cg     -- matrix-free preconditioned conjugate gradients with the
              reference's decaying tolerance schedule
              (`indirect.c:321-434`), expressed as `lax.while_loop` so it
              fuses into the jitted ADMM step.  Inner products become `psum`
              collectives when run under `shard_map`.

Auto-selection mirrors `src/abip-qcp/source/util.c:237-244`: direct when the
normal matrix is affordable, CG when m is large.
"""
from .dense import DenseNormalSolver
from .cg import CGSolver

__all__ = ["DenseNormalSolver", "CGSolver", "make_solver"]


def make_solver(A_op, m: int, n: int, rho_y: float, settings,
                normal_matrix=None):
    """Pick and build a KKT solver for operator `A_op`.

    `A_op` is an `abip.problem.LinearOperator` (supports `.matvec`,
    `.rmatvec`, optionally `.dense()`).  `normal_matrix` optionally
    supplies a precomputed rho_y*I + A A^T (e.g. assembled host-side from
    a sparse A), enabling the direct backend without a dense A.
    """
    kind = settings.linsys
    if kind == "auto":
        # Direct (dense Cholesky of the m x m normal matrix) when m is modest;
        # CG otherwise.  Mirrors the reference auto-select intent
        # (`src/abip-qcp/source/util.c:237-244`).
        direct_ok = A_op.has_dense or normal_matrix is not None
        kind = "dense" if m <= 4096 and direct_ok else "cg"
    if kind == "dense":
        return DenseNormalSolver(A_op, m, n, rho_y, settings,
                                 normal_matrix=normal_matrix)
    return CGSolver(A_op, m, n, rho_y, settings)
