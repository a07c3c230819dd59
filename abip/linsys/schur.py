"""Conic KKT backends: Schur-complement solvers for the DR block system.

The conic projection step needs

    [[R_y,  A  ],   [z_y]   [w_y]
     [-A^T, Q+R_x]] [z_x] = [w_x]

(the symmetrized form the reference assembles in `form_qcp_kkt`,
`/root/reference/src/abip-qcp/source/qcp_config.c:699-748`).  Eliminating
z_y = R_y^-1 (w_y - A z_x) gives the SPD n x n Schur system

    S z_x = w_x + A^T R_y^-1 w_y,      S = Q + R_x + A^T R_y^-1 A

which is exactly the operator of the reference's `qcp_pcg`
(`source/linsys.c:725-851`).  On the device:

  * dense: S is ONE matmul chain; Cholesky cached per solve
    (replaces MKL-DSS/QDLDL/PARDISO, `source/linsys.c:318-611`).
  * cg: matrix-free PCG with the Jacobi preconditioner of
    `init_qcp_precon` (`source/qcp_config.c:754-780`) and the tolerance
    ladder of `get_qcp_pcg_tol` (`:786-793`).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def _newton_inverse(S, steps=3):
    """f64-quality explicit inverse WITHOUT f64 triangular solves.

    f64 triangular solves are sequential (the n x n explicit inverse at
    dim-1020 runs 1020 of them in the conic device route's setup).  Jacobi-
    equilibrate (S_hat = D S D has unit diagonal, so its f32 Cholesky
    inverse is accurate at cond(S_hat) << cond(S) ~ 1/rho_y), invert in
    f32, then Newton steps X <- X + X(I - S_hat X) against the f64
    S_hat: the residual SQUARES each step (cond*eps32 ~ 1e-2 -> 1e-4 ->
    1e-8 -> 1e-16), and each step is two f64 MATMULS (parallel, unlike
    trisolves).  3 steps reach f64 roundoff for
    cond(S_hat) up to ~1e5."""
    d = 1.0 / jnp.sqrt(jnp.diag(S))
    S_hat = S * d[:, None] * d[None, :]
    n = S.shape[0]
    eye32 = jnp.eye(n, dtype=jnp.float32)
    X = jax.scipy.linalg.cho_solve(
        (jax.lax.linalg.cholesky(S_hat.astype(jnp.float32)), True),
        eye32).astype(S.dtype)
    eye = jnp.eye(n, dtype=S.dtype)
    for _ in range(steps):
        X = X + X @ (eye - S_hat @ X)
    return X * d[:, None] * d[None, :]


def _ir_apply(Minv, M, rhs, steps=2):
    """Backward-stable-quality solve from an explicit inverse: an
    inverse APPLY is not backward stable (||I - X M|| ~ cond * eps even
    for a Newton-exact X: measured 3.9e-6 at cond 1.6e6, which floored
    the conic dual residual at ~4e-6 and stalled solves that converge
    in ~100 iterations with trisolves).  Two vector-IR steps against
    the f64 matrix contract that error by ||I - X M|| each:
    4e-6 -> 1.6e-11 -> 6e-17.  All matmuls -- no emulated trisolves."""
    z = Minv @ rhs
    for _ in range(steps):
        z = z + Minv @ (rhs - M @ z)
    return z


class DenseSchurSolver:
    """Cached-Cholesky Schur solver for the conic block system.

    mode="inverse_mixed" applies the pre-computed f32 explicit inverse
    (one matmul) plus one f64 iterative-refinement step against the
    f64 Schur matrix -- the anchored mixed-precision pattern of
    `parallel/batched.py`, avoiding f64 triangular solves.
    """

    def __init__(self, A, Q, rho_y_vec, rho_x_vec, mode="chol",
                 form="auto", newton_steps=3):
        # A: (m, n) dense; Q: (n, n) dense, (n,) diagonal, or None
        if mode not in ("chol", "inverse_mixed", "newton"):
            raise ValueError(f"unknown dense mode: {mode!r}")
        self.newton_steps = newton_steps
        if form not in ("auto", "primal", "woodbury"):
            raise ValueError(f"unknown form: {form!r}")
        self.A = A
        self.Q = Q
        self.mode = mode
        self.ry_inv = 1.0 / rho_y_vec
        m, n = A.shape
        q_diag = Q if (Q is not None and Q.ndim == 1) else None

        # Dual (Woodbury) form: when H = Q + R_x is DIAGONAL, factor the
        # m x m  G = R_y + A H^-1 A'  instead of the n x n S.  This is
        # the reference's per-shape KKT dispatch (`lasso_config.c:507-565`
        # chooses (1/2 I + A'D^-1 A) vs (D + 2AA') by shape) generalized
        # to the generic config: with u = G^-1 A H^-1 rhs the solution
        # collapses to
        #   z_x = H^-1 (rhs - A'u),   z_y = R_y^-1 w_y - u,
        # i.e. 3 A-products + 2 m^2 trisolves per apply versus
        # 2 A-products + 2 n^2 trisolves.  Flop crossover: Woodbury wins
        # when 2m^2 + mn < 2n^2, i.e. m < 0.78n; form="auto" uses the
        # slightly conservative 4m <= 3n (measured 2.8x per-apply on
        # dim-1000 mixed-cone instances at m = n/3).  The batched device
        # driver's mixed-precision auto rule is tighter (2m <= n) because
        # its anchored IR adds two more A-products per apply.
        # mode="inverse_mixed" keeps the primal form (its equilibrated
        # f32 inverse is defined on S).
        diagonal_H = Q is None or q_diag is not None
        if form == "woodbury" and not diagonal_H:
            raise ValueError("form='woodbury' requires Q diagonal or None")
        if form == "woodbury" and mode == "inverse_mixed":
            raise ValueError("mode='inverse_mixed' is defined on the "
                             "primal Schur complement S")
        use_woodbury = (
            form == "woodbury"
            or (form == "auto" and mode in ("chol", "newton")
                and diagonal_H and 4 * m <= 3 * n)
        )
        self.form = "primal"
        if use_woodbury:
            self.form = "woodbury"
            H = rho_x_vec + (q_diag if q_diag is not None else 0.0)
            self.H_inv = 1.0 / H
            G = jnp.diag(rho_y_vec) + (A * self.H_inv[None, :]) @ A.T
            if mode == "newton":
                self.G64 = G
                self.Ginv64 = _newton_inverse(G, newton_steps)
            else:
                self.cholG = jax.lax.linalg.cholesky(G)
            return

        S = (A * self.ry_inv[:, None]).T @ A + jnp.diag(rho_x_vec)
        if Q is not None:
            S = S + (jnp.diag(q_diag) if q_diag is not None else Q)
        if mode == "newton":
            self.S64n = S
            self.Sinv64 = _newton_inverse(S, newton_steps)
            return
        self.chol = jax.lax.linalg.cholesky(S)
        if mode == "inverse_mixed":
            # S's conditioning is dominated by 1/rho_y (1e6 at conic
            # defaults) -- far beyond f32.  Jacobi-equilibrate first:
            # S_hat = D S D with D = diag(S)^-1/2 has unit diagonal, so
            # its f32 inverse is accurate; two IR steps against the f64 S
            # recover f64-quality solves.
            self.S64 = S
            self.d_S = 1.0 / jnp.sqrt(jnp.diag(S))
            S_hat = S * self.d_S[:, None] * self.d_S[None, :]
            eye = jnp.eye(n, dtype=S.dtype)
            self.Shat_inv32 = jax.scipy.linalg.cho_solve(
                (jax.lax.linalg.cholesky(S_hat), True), eye
            ).astype(jnp.float32)

    def _apply_inv(self, rhs, tol_hint=None):
        if self.mode == "newton":
            return _ir_apply(self.Sinv64, self.S64n, rhs)
        if self.mode == "chol":
            return jax.scipy.linalg.cho_solve((self.chol, True), rhs)

        def inv_mixed(r):
            def once(rr):
                rh = (self.d_S * rr).astype(jnp.float32)
                return self.d_S * (self.Shat_inv32 @ rh).astype(rr.dtype)

            # 3 IR steps: cond(S_hat) is spectral (~1/rho_y), so each f32
            # apply contracts error by ~cond*eps32; measured on the LP-cone
            # smoke shape, 3 steps reproduce the f64 trajectory exactly
            z = once(r)
            for _ in range(3):
                z = z + once(r - self.S64 @ z)
            return z

        def inv_exact(r):
            return jax.scipy.linalg.cho_solve((self.chol, True), r)

        if tol_hint is None:
            # setup-time solves (pre_calculate r-vector) need full accuracy
            return inv_exact(rhs)
        # bulk iterations ride the f32 inverse; once residuals approach
        # tolerance (error_ratio small) the f32 noise floor would stall the
        # inner criterion, so the endgame switches to the exact factor --
        # same pattern as the sprint engine's mu switch
        return jax.lax.cond(jnp.asarray(tol_hint) > 100.0,
                            inv_mixed, inv_exact, rhs)

    def solve(self, w_y, w_x, iter_count=0, warm_start=None, tol_hint=None):
        rhs = w_x + self.A.T @ (self.ry_inv * w_y)
        if self.form == "woodbury":
            t = self.H_inv * rhs
            u = (_ir_apply(self.Ginv64, self.G64, self.A @ t)
                 if self.mode == "newton"
                 else jax.scipy.linalg.cho_solve((self.cholG, True),
                                                 self.A @ t))
            z_x = t - self.H_inv * (self.A.T @ u)
            # A z_x = rho_y o u exactly (G u = A t), so
            # z_y = ry_inv*(w_y - A z_x) simplifies:
            z_y = self.ry_inv * w_y - u
            return z_y, z_x, jnp.zeros((), jnp.int32)
        z_x = self._apply_inv(rhs, tol_hint)
        z_y = self.ry_inv * (w_y - self.A @ z_x)
        return z_y, z_x, jnp.zeros((), jnp.int32)


# Pytree registration: the solver's arrays (factor, inverse, A) become
# jit-traceable INPUTS instead of baked-in constants, so one module-level
# jitted driver function compiles ONCE PER SHAPE and is shared by every
# same-shape instance (the per-instance closure pattern re-compiled per
# instance -- measured 0.8s of XLA compile per conic solve on a suite of
# identical shapes).
def _dense_schur_flatten(s):
    children = (s.A, s.Q, s.ry_inv,
                getattr(s, "chol", None),
                getattr(s, "H_inv", None), getattr(s, "cholG", None),
                getattr(s, "S64", None), getattr(s, "d_S", None),
                getattr(s, "Shat_inv32", None),
                getattr(s, "Sinv64", None), getattr(s, "Ginv64", None),
                getattr(s, "S64n", None), getattr(s, "G64", None))
    return children, (s.mode, s.form, getattr(s, "newton_steps", 3))


def _dense_schur_unflatten(aux, children):
    s = object.__new__(DenseSchurSolver)
    s.mode, s.form, s.newton_steps = aux
    (s.A, s.Q, s.ry_inv, chol, H_inv, cholG, S64, d_S,
     Shat_inv32, Sinv64, Ginv64, S64n, G64) = children
    if s.form == "woodbury":
        s.H_inv = H_inv
        if s.mode == "newton":
            s.Ginv64, s.G64 = Ginv64, G64
        else:
            s.cholG = cholG
    elif s.mode == "newton":
        s.Sinv64, s.S64n = Sinv64, S64n
    else:
        s.chol = chol
        if s.mode == "inverse_mixed":
            s.S64, s.d_S, s.Shat_inv32 = S64, d_S, Shat_inv32
    return s


jax.tree_util.register_pytree_node(
    DenseSchurSolver, _dense_schur_flatten, _dense_schur_unflatten)


class LowRankWoodburySolver:
    """Direct Schur solve when A H^-1 A' = diag(g) + U Hu U' with a
    THIN U (m x k, k << m): the device analogue of the reference's per-app
    custom KKT (`svm_config.c:577-637` solves (D + 2AA')-shaped systems
    instead of the generic KKT; our SVM operators' [yX, y, I, -I] block
    structure makes the Gram exactly diagonal-plus-rank-(n+1)).

    G = diag(rho_y + g) + U Hu U'; Sherman-Morrison-Woodbury gives

        G^-1 v = Dg^-1 v - Dg^-1 U C^-1 U' Dg^-1 v,
        C = Hu^-1 + U' Dg^-1 U            (k x k, factored ONCE),

    so setup is O(m k^2) and each apply O(m k) -- same economy as the
    reference's cached sparse factor, MXU-shaped.  `solve` implements
    the Woodbury dual form of `DenseSchurSolver.solve` with A applied
    matrix-free (`op.matvec`/`op.rmatvec`)."""

    def __init__(self, op, H_inv_diag, rho_y_vec, U, Hu_diag, g_diag):
        self.op = op
        self.H_inv = H_inv_diag
        self.ry_inv = 1.0 / rho_y_vec
        self.U = U
        self.dg_inv = 1.0 / (rho_y_vec + g_diag)
        C = jnp.diag(1.0 / Hu_diag) + (U * self.dg_inv[:, None]).T @ U
        self.cholC = jax.lax.linalg.cholesky(C)

    def _Ginv(self, v):
        t = self.dg_inv * v
        s = jax.scipy.linalg.cho_solve((self.cholC, True), self.U.T @ t)
        return t - self.dg_inv * (self.U @ s)

    def solve(self, w_y, w_x, iter_count=0, warm_start=None, tol_hint=None):
        rhs = w_x + self.op.rmatvec(self.ry_inv * w_y)
        t = self.H_inv * rhs
        u = self._Ginv(self.op.matvec(t))
        z_x = t - self.H_inv * self.op.rmatvec(u)
        # G u = A t exactly (the decomposition is EXACT, not a
        # preconditioner), so z_y = ry_inv (w_y - A z_x) collapses:
        z_y = self.ry_inv * w_y - u
        return z_y, z_x, jnp.zeros((), jnp.int32)


def pcg_tol_ladder(thresholds, coeffs):
    """Build an error-ratio-laddered PCG tolerance rule.

    Mirrors the per-app tables of the reference: coefficient is chosen by
    bucketing `error_ratio` over ascending `thresholds` (len(coeffs) must
    be len(thresholds)+1), then tol = max(1e-9, coef*norm_p/(k+1)^2).

    The tables stay host-side numpy here: this runs at import time for
    the module-level ladders, and creating a device array then would
    initialize the backend before callers can select a platform.  jnp
    ops inside `ladder`
    promote them when traced.
    """
    import numpy as np

    th = np.asarray(thresholds, float)
    cf = np.asarray(coeffs, float)
    if cf.shape[0] != th.shape[0] + 1:
        raise ValueError("need len(coeffs) == len(thresholds) + 1")

    def ladder(k, error_ratio, norm_p):
        coef = jnp.asarray(cf)[jnp.searchsorted(jnp.asarray(th),
                                                error_ratio, side="left")]
        return jnp.maximum(1e-9, coef * norm_p / (k + 1.0) ** 2)

    return ladder


# `get_lasso_pcg_tol` (`lasso_config.c:592-619`)
LASSO_PCG_LADDER = pcg_tol_ladder(
    [10, 30, 100, 300, 1e3, 3e3, 1e4, 3e4, 1e5],
    [5e-4, 6e-4, 8e-4, 1.5e-3, 2e-3, 3e-3, 5e-3, 6e-3, 8e-3, 1.2e-2],
)

# `get_svm_pcg_tol` (`svm_config.c:669-696`)
SVM_PCG_LADDER = pcg_tol_ladder(
    [10, 30, 100, 300, 1e3, 3e3, 1e4, 3e4, 1e5],
    [4e-3, 7e-3, 1e-2, 1.3e-2, 1.6e-2, 2e-2, 2.5e-2, 3e-2, 3e-2, 3e-2],
)


class CGSchurSolver:
    """Matrix-free PCG on the Schur system (mirrors `qcp_pcg`)."""

    def __init__(self, A_op, Q_op, rho_y_vec, rho_x_vec, diag_S,
                 max_iters=1000, tol_ladder=None):
        self.A_op = A_op      # LinearOperator (m, n)
        self.Q_op = Q_op      # callable x -> Qx, or None
        self.ry_inv = 1.0 / rho_y_vec
        self.rho_x = rho_x_vec
        self.M = 1.0 / diag_S  # Jacobi preconditioner (`init_qcp_precon`)
        self.max_iters = max_iters
        # per-problem tolerance rule (k, error_ratio, norm_p) -> tol;
        # default is the flat generic ladder of `get_qcp_pcg_tol`
        self.tol_ladder = tol_ladder

    def _S(self, x):
        y = self.A_op.matvec(x)
        out = self.A_op.rmatvec(self.ry_inv * y) + self.rho_x * x
        if self.Q_op is not None:
            out = out + self.Q_op(x)
        return out

    def solve(self, w_y, w_x, iter_count=0, warm_start=None, tol_hint=None):
        norm_p = jnp.linalg.norm(w_x)
        it = jnp.asarray(iter_count, w_x.dtype)
        if self.tol_ladder is not None and tol_hint is not None:
            # per-app error-ratio ladder (`lasso_config.c:592-619`)
            lad = self.tol_ladder(jnp.maximum(it, 0.0),
                                  jnp.asarray(tol_hint, w_x.dtype), norm_p)
        else:
            # `get_qcp_pcg_tol` (`qcp_config.c:786-793`)
            lad = jnp.maximum(
                1e-9, 1e-5 * norm_p / (jnp.maximum(it, 0.0) + 1.0) ** 2)
        tol = jnp.where(it < 0, 1e-9 * norm_p, lad)
        rhs = w_x + self.A_op.rmatvec(self.ry_inv * w_y)
        x0 = warm_start if warm_start is not None else jnp.zeros_like(w_x)

        M = self.M
        x = x0
        r = rhs - self._S(x)
        z = M * r
        p = z
        ipzr = jnp.dot(z, r)

        def cond(carry):
            x, r, p, ipzr, i = carry
            return (jnp.linalg.norm(r) >= tol) & (i < self.max_iters)

        def body(carry):
            x, r, p, ipzr, i = carry
            Sp = self._S(p)
            a = ipzr / jnp.dot(p, Sp)
            x = x + a * p
            r = r - a * Sp
            z = M * r
            new = jnp.dot(z, r)
            p = z + (new / ipzr) * p
            return (x, r, p, new, i + 1)

        z_x, r, p, ipzr, iters = jax.lax.while_loop(
            cond, body, (x, r, p, ipzr, jnp.zeros((), jnp.int32))
        )
        z_y = self.ry_inv * (w_y - self.A_op.matvec(z_x))
        return z_y, z_x, iters
