"""Direct KKT backend: dense Cholesky of the normal equations.

Dense replacement for the reference's AMD+LDL' sparse factorization of
the (m+n)^2 quasi-definite KKT (`/root/reference/src/abip-lp/linsys/direct.c:49-270`).
On an accelerator a sparse LDL' is a poor fit; the design (SURVEY.md section 7)
is a dense Cholesky of the m x m normal matrix

    N = rho_y * I + A A^T

factored ONCE at setup and reused by two triangular solves per ADMM
iteration -- the same "factorize once, solve every iteration" economy that
defines ABIP.  Forming A A^T is a single large matmul that maps straight
onto the MXU.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


class DenseNormalSolver:
    """Cached-Cholesky solver for K z = w with K = [[rho_y I, A], [A^T, -I]]."""

    def __init__(self, A_op, m, n, rho_y, settings, normal_matrix=None):
        self.A_op = A_op
        self.m = m
        self.n = n
        self.rho_y = rho_y
        if normal_matrix is None:
            A = A_op.dense()
            # One big MXU matmul; factor once per solve, reuse for every
            # ADMM iteration (cf. `direct.c:218-270` factorize-once).
            normal_matrix = rho_y * jnp.eye(m, dtype=A.dtype) + A @ A.T
        self.chol = jax.lax.linalg.cholesky(jnp.asarray(normal_matrix))
        self.avg_cg_iters = 0.0  # parity field; direct solves report 0

    def solve(self, w_y, w_x, iter_count=0, warm_start=None, tol_hint=None):
        """Solve K z = (w_y, w_x); returns (z_y, z_x, aux_iters).

        Derivation (matches `indirect.c:393-434`):
            (rho_y I + A A^T) z_y = w_y + A w_x
            z_x = A^T z_y - w_x
        """
        rhs = w_y + self.A_op.matvec(w_x)
        z_y = jax.scipy.linalg.cho_solve((self.chol, True), rhs)
        z_x = self.A_op.rmatvec(z_y) - w_x
        return z_y, z_x, jnp.zeros((), dtype=jnp.int32)
