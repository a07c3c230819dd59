"""LASSO as a rotated-second-order-cone program.

    min_w  (1/2) ||X w - y||^2 + lam * ||w||_1

Conic embedding (the reference's, `source/lasso_config.c:8-93` +
`mex/abip_ml_mex.c:320-330`, with the hand-tuned scale constants dropped --
our equilibration pipeline replaces them):

    variables  z = (t1, t2, r in R^m, w+ in R^n, w- in R^n)
    cones      K = RSOC(2+m) x R+^{2n}
    rows       t1 = 1
               r + X (w+ - w-) = y          (so r = y - X w)
    objective  min  t2 + lam * 1'(w+ + w-)

RSOC gives 2 t1 t2 >= ||r||^2 with t1 = 1, i.e. t2 >= ||y - Xw||^2 / 2,
tight at the optimum; w = w+ - w- recovers the signed weights.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..cones import ConeSpec


@dataclasses.dataclass
class ConicProblem:
    A: np.ndarray
    b: np.ndarray
    c: np.ndarray
    cones: ConeSpec
    recover: callable
    Q: np.ndarray | None = None
    # per-problem PCG tolerance ladder (k, error_ratio, norm_p) -> tol,
    # the role of `get_lasso_pcg_tol`/`get_svm_pcg_tol`
    tol_ladder: callable | None = None
    # custom KKT backend factory (op, rho_y_vec, rho_x_vec, Q_diag) ->
    # solver with DenseSchurSolver.solve's signature -- the role of the
    # reference vtable's `init_spe_linsys_work`/`solve_spe_linsys`
    # (`include/abip.h:29-60`); used in place of the generic CG path
    solver_factory: callable | None = None


def lasso_to_conic(X, y, lam: float) -> ConicProblem:
    X = np.asarray(X, float)
    y = np.asarray(y, float)
    m, n = X.shape
    if y.shape != (m,):
        raise ValueError(f"y must have shape ({m},); got {y.shape}")
    if lam <= 0:
        raise ValueError("lam must be positive")

    q = 2 + m + 2 * n
    p = 1 + m
    A = np.zeros((p, q))
    A[0, 0] = 1.0                       # t1 = 1
    A[1:, 2 : 2 + m] = np.eye(m)        # r
    A[1:, 2 + m : 2 + m + n] = X        # + X w+
    A[1:, 2 + m + n :] = -X             # - X w-
    b = np.concatenate([[1.0], y])
    c = np.zeros(q)
    c[1] = 1.0
    c[2 + m :] = lam

    cones = ConeSpec(rsoc=(2 + m,), nonneg=2 * n)

    def recover(sol):
        z = sol.x
        w = z[2 + m : 2 + m + n] - z[2 + m + n :]
        obj = 0.5 * np.sum((X @ w - y) ** 2) + lam * np.sum(np.abs(w))
        return w, obj

    return ConicProblem(A=A, b=b, c=c, cones=cones, recover=recover)


def lasso_operator(X, y, lam: float, scaled: bool = True) -> ConicProblem:
    """Matrix-free variant: the reformulated constraint matrix is never
    materialized; X is applied twice per matvec, exactly like
    `lasso_A_times` (`source/lasso_config.c:99-126`).

    Layout: A z = [t1;  r + X w+ - X w-],  z = (t1, t2, r, w+, w-).

    ANALYTIC equilibration is applied (`scaled=True`): the reformulated
    matrix's row/column norms are known in closed form from X, so the
    D/E/b/c scalings of the dense pipeline are reproduced without
    materializing anything -- the role of the hand-tuned constants in the
    reference config (`lasso_config.c:36-51`).  The solve runs in scaled
    units (tolerances apply there, as in the reference app configs);
    `recover` maps back.
    """
    import jax.numpy as jnp

    from ..problem import LinearOperator

    Xnp = np.asarray(X, float)
    y = np.asarray(y, float)
    m, n = Xnp.shape
    q = 2 + m + 2 * n
    p = 1 + m

    # analytic row/col norms of A = [[1,0,0,0,0],[0,0,I,X,-X]]
    row_sq = np.concatenate([[1.0], 1.0 + 2.0 * np.sum(Xnp * Xnp, axis=1)])
    colX_sq = np.sum(Xnp * Xnp, axis=0)
    col_sq = np.concatenate([[1.0, 1.0], np.ones(m), colX_sq, colX_sq])

    if scaled:
        D = np.sqrt(np.sqrt(row_sq))            # origin-style sqrt norms
        E = np.sqrt(np.sqrt(np.maximum(col_sq, 1e-8)))
        # tie E over the RSOC block (t1, t2, r) like the conic pipeline
        E[: 2 + m] = E[: 2 + m].mean()
    else:
        D = np.ones(p)
        E = np.ones(q)

    Dj = jnp.asarray(D)
    Ej = jnp.asarray(E)
    Xj = jnp.asarray(Xnp)

    def matvec(z):
        z = z / Ej                      # undo column scaling
        t1 = z[0]
        r = z[2 : 2 + m]
        w = z[2 + m : 2 + m + n] - z[2 + m + n :]
        out = jnp.concatenate([t1[None], r + Xj @ w])
        return out / Dj

    def rmatvec(u):
        u = u / Dj
        u0, ur = u[0], u[1:]
        xt = Xj.T @ ur
        out = jnp.concatenate(
            [u0[None], jnp.zeros((1,), u.dtype), ur, xt, -xt]
        )
        return out / Ej

    op = LinearOperator(p, q, matvec, rmatvec,
                        nnz=2 * int(np.prod(Xnp.shape)) + m + 1)
    # Jacobi diag for the Schur CG (`init_lasso_precon` analogue,
    # `lasso_config.c:571-587`): EXACT column norms of the scaled matrix,
    # computable analytically from the block structure
    Xd_sq = np.sum((Xnp / D[1:, None]) ** 2, axis=0)   # cols of X scaled by rows
    exact_col_sq = np.concatenate(
        [[1.0 / D[0] ** 2, 0.0], 1.0 / D[1:] ** 2, Xd_sq, Xd_sq]
    )
    op.col_norms_sq = exact_col_sq / (E * E)

    b = np.concatenate([[1.0], y])
    c = np.zeros(q)
    c[1] = 1.0
    c[2 + m :] = lam
    # b/c normalization (`scaling_qcp_data:462-485` analogue)
    sc = float(np.sqrt(np.sqrt(b @ b + c @ c)))
    sc = 1.0 if sc < 1e-3 else min(sc, 1e3)
    sc_b = sc_c = 1.0 / sc
    b_s = b / D * sc_b
    c_s = c / E * sc_c
    cones = ConeSpec(rsoc=(2 + m,), nonneg=2 * n)

    def recover(sol):
        z = np.asarray(sol.x) / (E * sc_b)   # un-scale (`un_scaling_qcp_sol`)
        w = z[2 + m : 2 + m + n] - z[2 + m + n :]
        obj = 0.5 * np.sum((Xnp @ w - y) ** 2) + lam * np.sum(np.abs(w))
        return w, obj

    from ..linsys.schur import LASSO_PCG_LADDER

    return ConicProblem(A=op, b=b_s, c=c_s, cones=cones, recover=recover,
                        tol_ladder=LASSO_PCG_LADDER)


def solve_lasso_batch(Xs, ys, lams, eps=1e-4, **kw):
    """Solve a sweep of same-shape LASSO instances as ONE device program.

    The device replacement for the reference's LASSO benchmark grid
    (`scripts/bench-qcp/test_lasso.m:36-120`, one process per instance):
    the whole (m, n, lambda) sweep is vmapped.  Returns (W, objs, result).
    """
    import jax.numpy as jnp

    from ..parallel.batched_qcp import solve_qcp_batch

    Xs = np.asarray(Xs, float)
    ys = np.asarray(ys, float)
    lams = np.asarray(lams, float)
    B, m, n = Xs.shape
    probs = [lasso_to_conic(Xs[i], ys[i], float(lams[i])) for i in range(B)]
    As = np.stack([p.A for p in probs])
    bs = np.stack([p.b for p in probs])
    cs = np.stack([p.c for p in probs])
    res = solve_qcp_batch(jnp.asarray(As), jnp.asarray(bs), jnp.asarray(cs),
                          cones=probs[0].cones, eps=eps, **kw)
    W = np.zeros((B, n))
    objs = np.zeros(B)
    for i in range(B):
        z = np.asarray(res.x[i])
        w = z[2 + m : 2 + m + n] - z[2 + m + n :]
        W[i] = w
        objs[i] = 0.5 * np.sum((Xs[i] @ w - ys[i]) ** 2) + lams[i] * np.abs(w).sum()
    return W, objs, res


def solve_lasso(X, y, lam: float, settings=None, matrix_free: bool = False,
                **overrides):
    """One-call LASSO solve; returns (w, objective, conic solution).

    Mirrors the `abip_ml` front door (`mex/abip_ml_mex.c:90-146`).
    `matrix_free=True` uses the operator form (X applied twice, the
    reformulated matrix never materialized) with CG linear solves.
    """
    from ..qcp import conic_defaults, solve_qcp

    if matrix_free:
        prob = lasso_operator(X, y, lam)
        settings = settings or conic_defaults(normalize=False, linsys="cg")
    else:
        prob = lasso_to_conic(X, y, lam)
    sol = solve_qcp(prob.A, prob.b, prob.c, prob.cones,
                    settings=settings, tol_ladder=prob.tol_ladder,
                    **overrides)
    w, obj = prob.recover(sol)
    return w, obj, sol
