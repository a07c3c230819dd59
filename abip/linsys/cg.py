"""Indirect KKT backend: Jacobi-preconditioned conjugate gradients.

JAX re-derivation of the reference PCG backend
(`/root/reference/src/abip-lp/linsys/indirect.c:321-434`):

  * operator: G y = rho_y * y + A (A^T y)   (normal equations, matrix-free)
  * preconditioner: M = diag(G)^-1 = 1 / (rho_y + row_norms_sq(A))
    (`indirect.c:36-79`)
  * tolerance schedule: ||rhs|| * CG_MIN_TOL / (iter+1)^cg_rate, floored at
    1e-7; CG_BEST_TOL=1e-9 for the one-time setup solve (`indirect.c:406-409`)
  * warm start from the previous iterate (`indirect.c:344-352`)

The loop is a `jax.lax.while_loop`, so it fuses into the jitted ADMM step with
no host syncs.  All reductions are `jnp` dots that become `psum` collectives
when the operator is sharded under `shard_map` (SURVEY.md section 3.4).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

CG_BEST_TOL = 1e-9
CG_MIN_TOL = 1e-1


def pcg(G, M, b, x0, tol, max_iters):
    """Jacobi-preconditioned CG: solve G(x) = b to ||r|| < tol.

    Pure function (reused by the solver classes and the shape-cached LP
    kernels); mirrors `pcg` (`indirect.c:321-391`)."""
    x = x0
    r = b - G(x)
    z = M * r
    p = z
    ipzr = jnp.dot(z, r)

    def cond(carry):
        x, r, p, ipzr, i = carry
        return (jnp.linalg.norm(r) >= tol) & (i < max_iters)

    def body(carry):
        x, r, p, ipzr, i = carry
        Gp = G(p)
        alpha = ipzr / jnp.dot(p, Gp)
        x = x + alpha * p
        r = r - alpha * Gp
        z = M * r
        ipzr_new = jnp.dot(z, r)
        p = z + (ipzr_new / ipzr) * p
        return (x, r, p, ipzr_new, i + 1)

    x, r, p, ipzr, iters = jax.lax.while_loop(
        cond, body, (x, r, p, ipzr, jnp.zeros((), jnp.int32))
    )
    return x, iters


def cg_tolerance(rhs_norm, iter_count, cg_rate, dtype):
    """Decaying tolerance schedule (`indirect.c:406-409`)."""
    it = jnp.asarray(iter_count, dtype)
    sched = jnp.where(
        it < 0,
        CG_BEST_TOL,
        CG_MIN_TOL / jnp.power(jnp.maximum(it, 0.0) + 1.0, cg_rate),
    )
    return jnp.maximum(rhs_norm * sched, 1e-7)


class CGSolver:
    """Matrix-free CG on (rho_y I + A A^T) z_y = w_y + A w_x."""

    def __init__(self, A_op, m, n, rho_y, settings):
        self.A_op = A_op
        self.m = m
        self.n = n
        self.rho_y = rho_y
        self.cg_rate = settings.cg_rate
        self.max_iters = min(settings.cg_max_iters, max(2 * m, 10))
        # Jacobi preconditioner: 1 / (rho_y + ||A_i,:||^2) per row.
        if A_op.has_dense:
            A = A_op.dense()
            row_sq = jnp.sum(A * A, axis=1)
        else:
            # Matrix-free diagonal estimate via e_i probes is O(m) matvecs;
            # fall back to the scalar bound diag(AA^T) ~ mean row norm.
            # Operators that know their diagonal can pass it via `row_norms_sq`.
            row_sq = getattr(A_op, "row_norms_sq", None)
            if row_sq is None:
                row_sq = jnp.zeros((m,), dtype=jnp.float64)
            else:
                row_sq = jnp.asarray(row_sq)
        self.M = 1.0 / (rho_y + row_sq)

    def _G(self, y):
        return self.rho_y * y + self.A_op.matvec(self.A_op.rmatvec(y))

    def _pcg(self, b, x0, tol):
        """Solve G x = b to ||r|| < tol, warm-started at x0."""
        M = self.M

        x = x0
        r = b - self._G(x)
        z = M * r
        p = z
        ipzr = jnp.dot(z, r)

        def cond(carry):
            x, r, p, ipzr, i = carry
            return (jnp.linalg.norm(r) >= tol) & (i < self.max_iters)

        def body(carry):
            x, r, p, ipzr, i = carry
            Gp = self._G(p)
            alpha = ipzr / jnp.dot(p, Gp)
            x = x + alpha * p
            r = r - alpha * Gp
            z = M * r
            ipzr_new = jnp.dot(z, r)
            p = z + (ipzr_new / ipzr) * p
            return (x, r, p, ipzr_new, i + 1)

        x, r, p, ipzr, iters = jax.lax.while_loop(
            cond, body, (x, r, p, ipzr, jnp.zeros((), jnp.int32))
        )
        return x, iters

    def solve(self, w_y, w_x, iter_count=0, warm_start=None, tol_hint=None):
        """Solve K z = (w_y, w_x) via normal equations + PCG."""
        rhs = w_y + self.A_op.matvec(w_x)
        nm = jnp.linalg.norm(rhs)
        # Decaying tolerance schedule (`indirect.c:406-409`).
        it = jnp.asarray(iter_count, dtype=rhs.dtype)
        sched = jnp.where(
            it < 0,
            CG_BEST_TOL,
            CG_MIN_TOL / jnp.power(jnp.maximum(it, 0.0) + 1.0, self.cg_rate),
        )
        tol = jnp.maximum(nm * sched, 1e-7)
        if tol_hint is not None:
            tol = jnp.minimum(tol, tol_hint)
        x0 = warm_start if warm_start is not None else jnp.zeros_like(w_y)
        z_y, iters = self._pcg(rhs, x0, tol)
        z_x = self.A_op.rmatvec(z_y) - w_x
        return z_y, z_x, iters
