"""ABIP linear programming driver.

Solves  min c'x  s.t. Ax = b, x >= 0  by the ADMM-based interior point
method on the homogeneous self-dual (HSD) embedding.

Device-first re-design of the reference LP core
(`/root/reference/src/abip-lp/src/abip.c`): the entire inner ADMM loop --
KKT projection, barrier prox, dual update, restart/averaging, inner
termination and convergence checks -- is ONE jitted `lax.while_loop` on
device (SURVEY.md section 7); the outer IPM loop runs on the host at a rate
of one sync per barrier stage, where the mu schedule (a table of host-side
branches, `abip.c:753-992`) lives naturally.

Iterates: u = (y, x, tau), v = (0, s, kappa), length l = m + n + 1
(`abip.c:2076`, `include/abip.h:136-150`).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .problem import LinearOperator
from .linsys import make_solver  # noqa: F401  (public seam, used by conic path)
from .scaling import equilibrate, normalize_bc, ScalingData
from .settings import Settings, Status
from . import schedules
from . import hsd
from .hsd import LPResiduals as Residuals

EPS_TOL = hsd.EPS_TOL
INDETERMINATE_TOL = 1e-9


class LPOperands(NamedTuple):
    """Problem data as a pytree ARGUMENT to the jitted kernels.

    Passing data as arguments (instead of closure constants) means the
    compiled kernels are cached per (kind, m, n, settings) -- one compile
    serves every instance of that shape, realizing the reference's
    init/solve split (`include/abip.h:116-123`) at the XLA level.
    Unused fields are None (their absence is part of the treedef).
    """

    A: object          # dense (m, n) array, or None for sparse kinds
    bcsr: object       # BCSRMatrix of A, or None
    bcsr_T: object     # BCSRMatrix of A', or None
    ell: object        # ELLMatrix of A, or None (scattered sparsity)
    ell_T: object      # ELLMatrix of A', or None
    chol: object       # (m, m) Cholesky factor, or None (cg kinds)
    M: object          # (m,) Jacobi preconditioner diag, or None
    h: jnp.ndarray
    g: jnp.ndarray
    g_th: jnp.ndarray
    b: jnp.ndarray
    c: jnp.ndarray
    pr_scale: jnp.ndarray
    dr_scale: jnp.ndarray
    obj_scale: jnp.ndarray
    nm_b: jnp.ndarray
    nm_c: jnp.ndarray


def _ops_matvec(ops: LPOperands, x):
    if ops.A is not None:
        return ops.A @ x
    if ops.ell is not None:
        from .ops.ell import ell_matvec

        return ell_matvec(ops.ell, x)
    from .ops.bcsr import bcsr_matvec

    return bcsr_matvec(ops.bcsr, x)


def _ops_rmatvec(ops: LPOperands, y):
    if ops.A is not None:
        return ops.A.T @ y
    if ops.ell_T is not None:
        from .ops.ell import ell_matvec

        return ell_matvec(ops.ell_T, y)
    from .ops.bcsr import bcsr_matvec

    return bcsr_matvec(ops.bcsr_T, y)


def _ops_solve(ops: LPOperands, stgs: Settings, w_y, w_x, k, warm):
    """KKT solve through the operand pytree (dense-direct or PCG)."""
    rhs = w_y + _ops_matvec(ops, w_x)
    if ops.chol is not None:
        z_y = jax.scipy.linalg.cho_solve((ops.chol, True), rhs)
        its = jnp.zeros((), jnp.int32)
    else:
        from .linsys.cg import cg_tolerance, pcg

        tol = cg_tolerance(jnp.linalg.norm(rhs), k, stgs.cg_rate, rhs.dtype)
        G = lambda y: stgs.rho_y * y + _ops_matvec(ops, _ops_rmatvec(ops, y))
        x0 = warm if warm is not None else jnp.zeros_like(w_y)
        z_y, its = pcg(G, ops.M, rhs, x0, tol, stgs.cg_max_iters)
    z_x = _ops_rmatvec(ops, z_y) - w_x
    return z_y, z_x, its


class InnerState(NamedTuple):
    """Carry of the jitted inner ADMM loop."""

    u: jnp.ndarray
    v: jnp.ndarray
    u_prev: jnp.ndarray
    u_avg: jnp.ndarray        # restart accumulator (`abip.c:587-630`)
    v_avg: jnp.ndarray
    u_sum: jnp.ndarray        # cumulative average (`abip.c:635-659`)
    v_sum: jnp.ndarray
    u_avgcon: jnp.ndarray
    v_avgcon: jnp.ndarray
    j: jnp.ndarray            # inner iteration counter
    k: jnp.ndarray            # global ADMM iteration counter
    qres: jnp.ndarray         # last inner-criterion value
    avg_criterion: jnp.ndarray  # bool: averaged iterate is the candidate
    status: jnp.ndarray       # Status code, 0 while running
    res: Residuals
    cg_iters: jnp.ndarray     # accumulated linsys aux iterations


# --------------------------------------------------------------------- #
# shape-cached kernels: jitted once per (operand treedef, shapes, stgs)  #
# --------------------------------------------------------------------- #
def _dims(ops: LPOperands):
    return ops.b.shape[0], ops.c.shape[0]


@partial(jax.jit, static_argnames=("stgs",))
def _project_k(ops: LPOperands, u, v, k, *, stgs: Settings):
    m, n = _dims(ops)
    solve_fn = lambda w_y, w_x, kk, warm: _ops_solve(ops, stgs, w_y, w_x, kk, warm)
    return hsd.project_lin_sys(u, v, ops.h, ops.g, ops.g_th, stgs.rho_y,
                               solve_fn, k, m, n)


@partial(jax.jit, static_argnames=("stgs",))
def _calc_residuals_k(ops: LPOperands, u, v, *, stgs: Settings):
    m, n = _dims(ops)
    return hsd.lp_residuals(
        u, v, partial(_ops_matvec, ops), partial(_ops_rmatvec, ops),
        ops.b, ops.c, ops.pr_scale, ops.dr_scale, ops.obj_scale,
        ops.nm_b, ops.nm_c, m, n,
    )


@partial(jax.jit, static_argnames=("stgs",))
def _bb_beta_k(ops: LPOperands, u, v, mu, *, stgs: Settings):
    from .adaptive import bb_update_beta

    m, n = _dims(ops)
    solve_fn = lambda w_y, w_x, kk, warm: _ops_solve(ops, stgs, w_y, w_x, kk, warm)
    return bb_update_beta(u, v, mu, ops.h, ops.g, ops.g_th, stgs.rho_y,
                          stgs.alpha, solve_fn, m, n,
                          stgs.adaptive_lookback, stgs.eps_cor, stgs.eps_pen)


@partial(jax.jit, static_argnames=("stgs",))
def _run_inner_k(ops: LPOperands, state: InnerState, mu, beta, gamma,
                 inner_stopper, final_check, ipm_i, max_iters, *,
                 stgs: Settings):
    """The hot loop: `abip.c:2131-2215` as one lax.while_loop."""
    m, n = _dims(ops)
    solve_fn = lambda w_y, w_x, kk, warm: _ops_solve(ops, stgs, w_y, w_x, kk, warm)

    def q_norm_resd(u, v):
        return hsd.q_norm_resd(u, v, partial(_ops_matvec, ops),
                               partial(_ops_rmatvec, ops), ops.b, ops.c, m, n)

    def inner_body(state: InnerState):
        u_prev = state.u
        u_t, its = hsd.project_lin_sys(state.u, state.v, ops.h, ops.g,
                                       ops.g_th, stgs.rho_y, solve_fn,
                                       state.k, m, n)
        lam = mu / beta
        if stgs.half_update:
            u, v = hsd.admm_update_half(state.u, state.v, u_t, lam, m)
        else:
            u, v = hsd.admm_update(state.u, state.v, u_prev, u_t, lam,
                                   stgs.alpha, m)

        # restart (`abip.c:587-630`): accumulate, then average every
        # restart_fre iterations once past restart_thresh.
        u_avg = state.u_avg + u
        v_avg = state.v_avg + v
        fre = stgs.restart_fre
        do_restart = (state.k >= stgs.restart_thresh) & ((state.j + 1) % fre == 0)
        u = jnp.where(do_restart, u_avg / fre, u)
        v = jnp.where(do_restart, v_avg / fre, v)
        u_avg = jnp.where(do_restart, jnp.zeros_like(u_avg), u_avg)
        v_avg = jnp.where(do_restart, jnp.zeros_like(v_avg), v_avg)

        # cumulative average candidate (`abip.c:635-659`)
        u_sum = state.u_sum + u
        v_sum = state.v_sum + v
        dom = (state.j + 1).astype(u.dtype)
        u_avgcon = u_sum / dom
        v_avgcon = v_sum / dom

        # inner criterion (`abip.c:1951-2051`): every 10th iteration also
        # evaluate the averaged iterate and adopt it if better.  With
        # qres_period > 1 the criterion (2 matvecs) runs only every P-th
        # iteration and stays stale in between (stage overrun <= P-1).
        def q_update(_):
            q_cur = q_norm_resd(u, v)

            def with_avg(_):
                q_avg = q_norm_resd(u_avgcon, v_avgcon)
                better = q_avg < q_cur
                return jnp.where(better, q_avg, q_cur), better

            def without_avg(_):
                return q_cur, jnp.zeros((), bool)

            return jax.lax.cond(
                (state.j + 1) % 10 == 0, with_avg, without_avg, operand=None
            )

        if stgs.qres_period == 1:
            qres, avg_crit = q_update(None)
        else:
            do_q = (((state.j + 1) % stgs.qres_period == 0)
                    | ((state.j + 1) % 10 == 0))
            qres, avg_crit = jax.lax.cond(
                do_q, q_update,
                lambda _: (state.qres, state.avg_criterion), operand=None
            )

        # convergence check (CONVERGED_INTERVAL=1) when final_check is on
        u_sel = jnp.where(avg_crit, u_avgcon, u)
        v_sel = jnp.where(avg_crit, v_avgcon, v)

        def check(_):
            r = hsd.lp_residuals(
                u_sel, v_sel, partial(_ops_matvec, ops),
                partial(_ops_rmatvec, ops), ops.b, ops.c, ops.pr_scale,
                ops.dr_scale, ops.obj_scale, ops.nm_b, ops.nm_c, m, n,
            )
            st = hsd.lp_converged_code(r, stgs.eps, stgs.pfeasopt,
                                       (ipm_i > 0) & (state.k > 0))
            return r, st

        def no_check(_):
            return state.res, jnp.zeros((), jnp.int32)

        res, status = jax.lax.cond(final_check, check, no_check, operand=None)

        return InnerState(
            u=u, v=v, u_prev=u_prev,
            u_avg=u_avg, v_avg=v_avg,
            u_sum=u_sum, v_sum=v_sum,
            u_avgcon=u_avgcon, v_avgcon=v_avgcon,
            j=state.j + 1, k=state.k + 1,
            qres=qres,
            avg_criterion=avg_crit,
            status=status,
            res=res,
            cg_iters=state.cg_iters + its,
        )

    def cond(s: InnerState):
        return (
            (s.j < inner_stopper)
            & (s.qres >= gamma * mu)
            & (s.status == 0)
            & (s.k < max_iters)
        )

    out = jax.lax.while_loop(cond, lambda s: inner_body(s), state)
    if stgs.half_update:
        # On a qres-triggered break only, lift strictly negative duals to
        # 1e-6 (`abip.c:2175-2185`); small positives and the y-block are
        # left untouched.
        qres_exit = (out.qres < gamma * mu) & (out.status == 0)
        out = out._replace(
            v=jnp.where(qres_exit & (out.v < 0), 1e-6, out.v)
        )
    return out


@dataclass
class LPSolution:
    x: np.ndarray
    y: np.ndarray
    s: np.ndarray
    status: int
    status_name: str
    pobj: float
    dobj: float
    res_pri: float
    res_dual: float
    rel_gap: float
    res_infeas: float
    res_unbdd: float
    ipm_iters: int
    admm_iters: int
    setup_time: float
    solve_time: float
    avg_cg_iters: float = 0.0


@partial(jax.jit, static_argnames=("stgs",))
def _lp_dense_setup_shared(A, b, c, *, stgs):
    """Compiled-per-shape dense LP setup.

    Equilibration, b/c normalization (`normalize.c:11-40`), the normal
    matrix + Cholesky (`direct.c:218-270`), and the rank-1 HSD data
    g = K^-1 h (`abip.c:1917-1924`) as ONE jitted program: previously
    ~260ms of eager dispatches per bench-shape instance (18% of wall),
    now ~2ms warm.  Returns (scal, sc_b, sc_c, ops, nm_b, nm_c)."""
    dtype = A.dtype
    m, n = A.shape
    nm_b = jnp.linalg.norm(b)
    nm_c = jnp.linalg.norm(c)

    if stgs.normalize:
        A_s, scal = equilibrate(A, stgs)
        b_s, c_s, sc_b, sc_c = normalize_bc(scal, b, c, stgs.scale)
    else:
        A_s, b_s, c_s = A, b, c
        scal = ScalingData(
            D=jnp.ones((m,), dtype), E=jnp.ones((n,), dtype),
            mean_norm_row=jnp.ones((), dtype),
            mean_norm_col=jnp.ones((), dtype),
        )
        sc_b = jnp.ones((), dtype)
        sc_c = jnp.ones((), dtype)

    direct = stgs.linsys == "dense" or (
        stgs.linsys == "auto" and m <= 4096 and float(m) * float(n) <= 5e7
    )
    chol = M = None
    if direct:
        N = stgs.rho_y * jnp.eye(m, dtype=dtype) + A_s @ A_s.T
        chol = jax.lax.linalg.cholesky(N)
    else:
        M = 1.0 / (stgs.rho_y + jnp.sum(A_s * A_s, axis=1))

    normalize = stgs.normalize
    pr_scale = (scal.D / (sc_b * stgs.scale)) if normalize \
        else jnp.ones((m,), dtype)
    dr_scale = (scal.E / (sc_c * stgs.scale)) if normalize \
        else jnp.ones((n,), dtype)
    obj_scale = (stgs.scale * sc_c * sc_b) if normalize \
        else jnp.ones((), dtype)

    h = jnp.concatenate([-b_s, c_s])
    ops = LPOperands(
        A=A_s, bcsr=None, bcsr_T=None, ell=None, ell_T=None,
        chol=chol, M=M, h=h, g=h, g_th=jnp.zeros((), dtype),
        b=b_s, c=c_s, pr_scale=pr_scale, dr_scale=dr_scale,
        obj_scale=obj_scale, nm_b=nm_b, nm_c=nm_c,
    )
    g_y, g_x, _ = _ops_solve(ops, stgs, h[:m], h[m:], -1, None)
    g = jnp.concatenate([g_y, -g_x])
    ops = ops._replace(g=g, g_th=jnp.dot(h, g))
    return scal, sc_b, sc_c, ops, nm_b, nm_c


class LPWorkspace:
    """Setup-once state: scaled data, cached factorization, jitted kernels.

    Mirrors the `ABIP(init)` / `ABIP(solve)` split (`abip.c:2341-2422`) so a
    single factorization can serve repeated solves.
    """

    def __init__(self, A, b, c, settings: Settings = Settings()):
        settings = settings.resolved()
        settings.validate()
        t0 = time.perf_counter()
        self.stgs = settings
        dtype = jnp.dtype(settings.dtype)
        self.dtype = dtype

        import scipy.sparse as sps

        is_sparse = sps.issparse(A)
        if not is_sparse:
            A = jnp.asarray(A, dtype)
        b = jnp.asarray(b, dtype)
        c = jnp.asarray(c, dtype)
        if A.ndim != 2:
            raise ValueError(f"A must be 2-D; got shape {A.shape}")
        m, n = A.shape
        if m <= 0 or n <= 0:
            raise ValueError(f"m and n must be positive; got m={m}, n={n}")
        if b.shape != (m,):
            raise ValueError(f"b must have shape ({m},) to match A; got {b.shape}")
        if c.shape != (n,):
            raise ValueError(f"c must have shape ({n},) to match A; got {c.shape}")
        # finite-data validation (`validate`, `abip.c:1646-1734`): NaN/inf
        # data otherwise propagates into a misleading Unbounded exit
        A_vals = A.data if is_sparse else A
        if not (bool(jnp.all(jnp.isfinite(A_vals)))
                if not is_sparse else bool(np.all(np.isfinite(A_vals)))):
            raise ValueError("A contains NaN or infinite entries")
        if not bool(jnp.all(jnp.isfinite(b))):
            raise ValueError("b contains NaN or infinite entries")
        if not bool(jnp.all(jnp.isfinite(c))):
            raise ValueError("c contains NaN or infinite entries")
        self.m, self.n = m, n
        self.l = m + n + 1
        nnz = int(A.nnz) if is_sparse else int(jnp.sum(A != 0))
        self.sp = nnz / (m * n)

        if not is_sparse:
            # dense path: one compiled-per-shape setup program (see
            # `_lp_dense_setup_shared`)
            (self.scal, self.sc_b, self.sc_c, ops,
             self.nm_b, self.nm_c) = _lp_dense_setup_shared(
                A, b, c, stgs=settings)
            self.b, self.c = ops.b, ops.c
            self.A_op = LinearOperator.from_dense(ops.A, nnz=nnz)
            self.linsys_kind = "dense" if ops.chol is not None else "cg"
            self.h, self.g, self.g_th = ops.h, ops.g, ops.g_th
            self.ops = ops
            self._build_kernels()
            self.setup_time = time.perf_counter() - t0
            return

        # norms of the ORIGINAL data (used by certificates, `abip.c:1855-1856`)
        self.nm_b = jnp.linalg.norm(b)
        self.nm_c = jnp.linalg.norm(c)

        # -- equilibration (`linsys/common.c:150-565`) -----------------------
        if settings.normalize:
            from .scaling import equilibrate_sparse

            A_s, scal = equilibrate_sparse(A, settings)
            b_s, c_s, sc_b, sc_c = normalize_bc(scal, b, c, settings.scale)
        else:
            A_s, b_s, c_s = A, b, c
            scal = ScalingData(
                D=jnp.ones((m,), dtype),
                E=jnp.ones((n,), dtype),
                mean_norm_row=jnp.ones((), dtype),
                mean_norm_col=jnp.ones((), dtype),
            )
            sc_b = jnp.ones((), dtype)
            sc_c = jnp.ones((), dtype)
        self.scal, self.sc_b, self.sc_c = scal, sc_b, sc_c
        self.b, self.c = b_s, c_s

        # -- linear-system payload -------------------------------------------
        # Direct (cached Cholesky of rho_y I + A A') when the normal matrix
        # is affordable, PCG otherwise.  Mirrors the reference auto-select
        # shape rule (`source/util.c:237-244`: PCG when m*n is huge) --
        # m alone is not enough: assembling AA' costs O(m^2) memory and
        # O(nnz*m) work, so large sparse problems must take the CG path
        # even at modest m.
        direct = settings.linsys == "dense" or (
            settings.linsys == "auto"
            and m <= 4096
            and float(m) * float(n) <= 5e7
        )
        A_dense = bcsr = bcsr_T = ell = ell_T = chol = M = None
        self.A_op = LinearOperator.from_scipy_sparse(A_s, dtype=dtype)
        if hasattr(self.A_op, "ell"):
            ell, ell_T = self.A_op.ell, self.A_op.ell_T
        else:
            bcsr, bcsr_T = self.A_op.bcsr, self.A_op.bcsr_T
        if direct:
            # normal matrix assembled host-side (the sparse-A analogue
            # of the one-time factorization, `direct.c:218-270`)
            N = (A_s @ A_s.T).toarray()
            N[np.diag_indices(m)] += settings.rho_y
            chol = jax.lax.linalg.cholesky(jnp.asarray(N, dtype))
        else:
            M = 1.0 / (settings.rho_y + self.A_op.row_norms_sq)
        self.linsys_kind = "dense" if direct else "cg"

        normalize = settings.normalize
        scale = settings.scale
        pr_scale = (scal.D / (sc_b * scale)) if normalize else jnp.ones((m,), dtype)
        dr_scale = (scal.E / (sc_c * scale)) if normalize else jnp.ones((n,), dtype)
        obj_scale = (scale * sc_c * sc_b) if normalize else jnp.ones((), dtype)

        # -- HSD rank-1 data: h = (-b; c), g = K^-1 h (x-part negated),
        #    g_th = h.g   (`abip.c:1917-1924`) -------------------------------
        # The reference solves K g = h then negates g[m:] (`abip.c:1922-1923`).
        h = jnp.concatenate([-b_s, c_s])
        zero = jnp.zeros((), dtype)
        ops = LPOperands(
            A=A_dense, bcsr=bcsr, bcsr_T=bcsr_T, ell=ell, ell_T=ell_T,
            chol=chol, M=M,
            h=h, g=h, g_th=zero, b=b_s, c=c_s,
            pr_scale=pr_scale, dr_scale=dr_scale, obj_scale=obj_scale,
            nm_b=self.nm_b, nm_c=self.nm_c,
        )
        g_y, g_x, _ = _ops_solve(ops, settings, h[:m], h[m:], -1, None)
        g = jnp.concatenate([g_y, -g_x])
        self.h, self.g = h, g
        self.g_th = jnp.dot(h, g)
        self.ops = ops._replace(g=g, g_th=self.g_th)

        self._build_kernels()
        self.setup_time = time.perf_counter() - t0

    # ------------------------------------------------------------------ #
    # jitted kernels                                                     #
    # ------------------------------------------------------------------ #
    def _build_kernels(self):
        """Bind the shape-cached module-level kernels to this workspace."""
        ops = self.ops
        stgs = self.stgs
        self._run_inner = partial(_run_inner_k, ops, stgs=stgs)
        self._calc_residuals = partial(_calc_residuals_k, ops, stgs=stgs)
        self._bb_beta = partial(_bb_beta_k, ops, stgs=stgs)
        self.project_lin_sys = partial(_project_k, ops, stgs=stgs)

    def update_problem(self, b, c) -> "LPWorkspace":
        """Re-target this workspace at new b, c with the SAME A.

        The reference splits `ABIP(init)`/`ABIP(solve)` precisely so one
        factorization serves repeated solves with new data
        (`include/abip.h:116-123`).  Here the cached Cholesky factor AND
        the compiled kernels are both reused: only the b/c-derived operand
        fields change (one extra KKT solve for the new rank-1 g).
        """
        stgs = self.stgs
        dtype = self.dtype
        m, n = self.m, self.n
        b = jnp.asarray(b, dtype)
        c = jnp.asarray(c, dtype)
        if b.shape != (m,) or c.shape != (n,):
            raise ValueError(f"b/c must have shapes ({m},)/({n},)")
        self.nm_b = jnp.linalg.norm(b)
        self.nm_c = jnp.linalg.norm(c)
        scal = self.scal
        if stgs.normalize:
            c_s = c / scal.E
            sc_c = scal.mean_norm_row / jnp.maximum(jnp.linalg.norm(c_s), 1e-3)
            b_s = b / scal.D
            sc_b = scal.mean_norm_col / jnp.maximum(jnp.linalg.norm(b_s), 1e-3)
            c_s = c_s * sc_c * stgs.scale
            b_s = b_s * sc_b * stgs.scale
        else:
            b_s, c_s = b, c
            sc_b = jnp.ones((), dtype)
            sc_c = jnp.ones((), dtype)
        self.sc_b, self.sc_c = sc_b, sc_c
        self.b, self.c = b_s, c_s

        normalize = stgs.normalize
        scale = stgs.scale
        pr_scale = (scal.D / (sc_b * scale)) if normalize else jnp.ones((m,), dtype)
        dr_scale = (scal.E / (sc_c * scale)) if normalize else jnp.ones((n,), dtype)
        obj_scale = (scale * sc_c * sc_b) if normalize else jnp.ones((), dtype)

        h = jnp.concatenate([-b_s, c_s])
        ops = self.ops._replace(b=b_s, c=c_s, pr_scale=pr_scale,
                                dr_scale=dr_scale, obj_scale=obj_scale,
                                nm_b=self.nm_b, nm_c=self.nm_c, h=h)
        g_y, g_x, _ = _ops_solve(ops, stgs, h[:m], h[m:], -1, None)
        g = jnp.concatenate([g_y, -g_x])
        self.h, self.g = h, g
        self.g_th = jnp.dot(h, g)
        self.ops = ops._replace(g=g, g_th=self.g_th)
        self._build_kernels()
        return self

    def shard(self, mesh, axis: str = "rows",
              linsys: str = "cg") -> "LPWorkspace":
        """Distribute this workspace over a device mesh: the FULL ADMM
        loop then iterates distributed.

        A is placed block-row sharded; the unchanged jitted kernels run
        under XLA's SPMD partitioner, which inserts the collectives the
        explicit `parallel/sharded.py` kernels spell out by hand (psum at
        every A'y and CG dot; row-local A x) -- the design the reference
        exposes at its `solve_lin_sys` seam (`include/linsys.h:12-20`).

        linsys="cg" (default): the KKT solve becomes the distributed
        Jacobi-PCG on rho_y I + AA' -- the scalable choice; a dense
        factor, if present, is dropped.  linsys="dense": keep the cached
        Cholesky factor but REPLICATED (row-sharding a triangular factor
        makes every `cho_solve` gather it; measured round 1).
        """
        from jax.sharding import NamedSharding, PartitionSpec as P

        ndev = mesh.devices.size
        if self.m % ndev != 0:
            raise ValueError(
                f"m={self.m} must be divisible by the mesh size {ndev}"
            )
        ops = self.ops
        if ops.A is None:
            raise ValueError(
                "shard() requires dense operands (BCSR/ELL sharding: use "
                "the batched suite path instead)"
            )
        row = NamedSharding(mesh, P(axis))
        rowmat = NamedSharding(mesh, P(axis, None))
        repl_sharding = NamedSharding(mesh, P())
        repl = {"A": jax.device_put(ops.A, rowmat)}
        if linsys == "cg":
            if ops.chol is not None:
                # switch direct -> distributed PCG: Jacobi diag of
                # rho_y I + AA' (`indirect.c:36-79`)
                M = 1.0 / (self.stgs.rho_y + jnp.sum(ops.A * ops.A, axis=1))
                repl["chol"] = None
                repl["M"] = jax.device_put(M, row)
                self.linsys_kind = "cg"
            elif ops.M is not None:
                repl["M"] = jax.device_put(ops.M, row)
        elif linsys == "dense":
            if ops.chol is None:
                raise ValueError("no cached factor: workspace was built "
                                 "with linsys='cg'")
            repl["chol"] = jax.device_put(ops.chol, repl_sharding)
        else:
            raise ValueError(f"linsys must be 'cg' or 'dense'; got {linsys!r}")
        repl["b"] = jax.device_put(ops.b, row)
        repl["pr_scale"] = jax.device_put(ops.pr_scale, row)
        self.ops = ops._replace(**repl)
        self._build_kernels()
        return self

    # ------------------------------------------------------------------ #
    # host-side driver                                                   #
    # ------------------------------------------------------------------ #
    def _cold_start(self, mu, beta):
        """`cold_start_vars` (`abip.c:361-381`)."""
        m, l = self.m, self.l
        val = np.sqrt(mu / beta)
        u = jnp.concatenate([
            jnp.zeros((m,), self.dtype),
            jnp.full((l - m,), val, self.dtype),
        ])
        return u, u

    def _warm_start(self, warm, mu, beta):
        """Seed u, v from a caller-provided (x, y, s) in original units.

        Intended semantics of `warm_start_vars` + `normalize_warm_start`
        (`abip.c:307-357`, `normalize.c:100-128`).  NOTE: the reference's
        own validation loop (`abip.c:326-349`) overwrites the entire warm
        start with the cold-start value -- a bug we do not replicate;
        here the barrier coordinates are floored at sqrt(mu/beta)*1e-3 to
        stay safely interior instead.
        """
        x, y, s = (np.asarray(a, float) for a in warm)
        m, n, l = self.m, self.n, self.l
        if x.shape != (n,) or y.shape != (m,) or s.shape != (n,):
            raise ValueError("warm start must be (x (n,), y (m,), s (n,))")
        D = np.asarray(self.scal.D)
        E = np.asarray(self.scal.E)
        sc_b = float(self.sc_b)
        sc_c = float(self.sc_c)
        x_s = x * (E * sc_b)
        y_s = y * (D * sc_c)
        s_s = s / (E / (sc_c * self.stgs.scale))
        floor = np.sqrt(mu / beta) * 1e-3
        u = jnp.asarray(
            np.concatenate([y_s, np.maximum(x_s, floor), [1.0]]), self.dtype
        )
        v = jnp.asarray(
            np.concatenate([np.zeros(m), np.maximum(s_s, floor), [floor]]),
            self.dtype,
        )
        return u, v

    def _init_inner_state(self, u, v):
        l = self.l
        z = jnp.zeros((l,), self.dtype)
        return InnerState(
            u=u, v=v, u_prev=u,
            u_avg=z, v_avg=z, u_sum=z, v_sum=z,
            u_avgcon=u, v_avgcon=v,
            j=jnp.zeros((), jnp.int32), k=jnp.zeros((), jnp.int32),
            qres=jnp.full((), jnp.inf, self.dtype),
            avg_criterion=jnp.zeros((), bool),
            status=jnp.zeros((), jnp.int32),
            res=Residuals.init(self.dtype),
            cg_iters=jnp.zeros((), jnp.int32),
        )

    def solve(self, warm=None, resume=None, checkpoint_path=None,
              checkpoint_every=0) -> LPSolution:
        """Run the outer IPM loop.

        warm: optional (x, y, s) seed in original units.
        resume: optional `SolverCheckpoint` to continue a prior solve.
        checkpoint_path/checkpoint_every: save state every k outer
        iterations (SURVEY.md section 5.4 -- the iterate is a small
        pytree, so preemption recovery is an .npz round-trip).
        """
        from .utils import IterationLog, PhaseTimers, solver_banner
        from .utils.checkpoint import SolverCheckpoint

        stgs = self.stgs
        m, n, l = self.m, self.n, self.l
        t0 = time.perf_counter()
        log = IterationLog(enabled=stgs.verbose)
        timers = PhaseTimers()
        self._timers = timers
        if stgs.verbose:
            print(solver_banner("LP", m, n, self.A_op.nnz,
                                self.linsys_kind))

        # `update_work` (`abip.c:1843-1927`): sigma/gamma by sparsity
        sp_hi = max(self.sp, stgs.sparsity_ratio)
        sp_lo = min(self.sp, stgs.sparsity_ratio)
        if sp_hi > 0.4 or (0.1 < sp_lo < 0.2):
            sigma, gamma = 0.3, 2.0
        elif sp_lo > 0.2:
            sigma, gamma = 0.5, 3.0
        else:
            sigma, gamma = 0.8, 3.0

        mu, beta = 1.0, 1.0
        final_check = False
        double_check = False
        dynamic_sigma = stgs.dynamic_sigma

        i0 = 0
        if resume is not None:
            u = jnp.asarray(resume.u, self.dtype)
            v = jnp.asarray(resume.v, self.dtype)
            mu, beta = resume.mu, resume.beta
            sigma, gamma = resume.sigma, resume.gamma
            final_check = resume.final_check
            i0 = resume.ipm_iters
        elif warm is not None:
            u, v = self._warm_start(warm, mu, beta)
        else:
            u, v = self._cold_start(mu, beta)
        state = self._init_inner_state(u, v)
        if resume is not None:
            state = state._replace(
                k=jnp.asarray(resume.admm_iters, jnp.int32))

        status = Status.UNFINISHED
        ipm_iter = i0
        admm_total = int(state.k)
        res_np = None
        max_admm = stgs.max_admm_iters

        # SIGINT listener (`ctrlc.c:62-92`): ctrl-C sets a flag, the loop
        # exits at the next stage boundary and the current best iterate is
        # returned with status ABIP_SIGINT.
        import signal

        interrupted = False

        def _on_sigint(signum, frame):
            nonlocal interrupted
            interrupted = True

        try:
            old_handler = signal.signal(signal.SIGINT, _on_sigint)
        except ValueError:          # not the main thread
            old_handler = None

        for i in range(i0, stgs.max_ipm_iters):
            ipm_iter = i
            if interrupted:
                status = Status.SIGINT
                break
            # inner_stopper by sparsity (`abip.c:2104-2115`)
            if sp_lo > 0.5:
                inner_stopper = max(1, int(round(mu ** -0.35)))
            elif sp_lo > 0.2:
                inner_stopper = max(1, int(round(mu ** -1.0)))
            else:
                inner_stopper = max_admm

            # reset per-stage accumulators; adopt averaged iterate if selected
            avg_crit = bool(state.avg_criterion)
            u = state.u_avgcon if avg_crit else state.u
            v = state.v_avgcon if avg_crit else state.v
            z = jnp.zeros((l,), self.dtype)
            state = state._replace(
                u=u, v=v,
                u_avg=z, v_avg=z, u_sum=z, v_sum=z,
                j=jnp.zeros((), jnp.int32),
                qres=jnp.full((), jnp.inf, self.dtype),
                status=jnp.zeros((), jnp.int32),
            )

            with timers.phase("inner_admm"):
                state = self._run_inner(
                    state,
                    jnp.asarray(mu, self.dtype),
                    jnp.asarray(beta, self.dtype),
                    jnp.asarray(gamma, self.dtype),
                    jnp.asarray(inner_stopper, jnp.int32),
                    jnp.asarray(final_check, bool),
                    jnp.asarray(i, jnp.int32),
                    jnp.asarray(max_admm, jnp.int32),
                )
                jax.block_until_ready(state.u)
            admm_total = int(state.k)
            inner_status = int(state.status)
            if inner_status != 0:
                status = inner_status
                res_np = jax.tree.map(float, state.res)._asdict()
                break

            # time limit (`abip.c:2217-2221`)
            if time.perf_counter() - t0 > stgs.max_time:
                max_admm = int(admm_total * 1.05) + 1

            if mu < stgs.eps:
                final_check = True

            # outer-loop residual check (`abip.c:2229-2248`)
            avg_crit = bool(state.avg_criterion)
            u_sel = state.u_avgcon if avg_crit else state.u
            v_sel = state.v_avgcon if avg_crit else state.v
            with timers.phase("residuals"):
                r = self._calc_residuals(u_sel, v_sel)
                res_np = jax.tree.map(float, r)._asdict()
            state = state._replace(res=r)

            pobj = res_np["ct_x_by_tau"] / max(res_np["tau"], EPS_TOL)
            dobj = res_np["bt_y_by_tau"] / max(res_np["tau"], EPS_TOL)
            log.row(i, admm_total, mu, res_np, pobj, dobj)

            status = schedules.check_converged(res_np, stgs, i, admm_total)
            if status != 0 or admm_total + 1 >= max_admm:
                break

            # mu update (`abip.c:2251-2277`)
            u_np = np.asarray(u_sel)
            v_np = np.asarray(v_sel)
            mu, sigma, gamma, final_check, double_check, dynamic_sigma = (
                schedules.update_mu(
                    mu, sigma, gamma, res_np, stgs, self.sp,
                    final_check, double_check, dynamic_sigma,
                    u=u_np, v=v_np, m=m,
                )
            )

            if checkpoint_path and checkpoint_every and (i + 1) % checkpoint_every == 0:
                avg_c = bool(state.avg_criterion)
                SolverCheckpoint(
                    u=np.asarray(state.u_avgcon if avg_c else state.u),
                    v=np.asarray(state.v_avgcon if avg_c else state.v),
                    mu=mu, beta=beta, sigma=sigma, gamma=gamma,
                    admm_iters=admm_total, ipm_iters=i + 1,
                    final_check=final_check,
                ).save(checkpoint_path)

            # reinitialize for next stage (`abip.c:996-1075`, indx=0)
            state = self._reinit(state, sigma)

            # adaptive penalty via BB spectral trials (`abip.c:2281-2293`):
            # sandwich the search between sqrt(sigma) re-scalings (indx=1/2)
            if stgs.adaptive:
                with timers.phase("adaptive_bb"):
                    state = self._reinit_scale(state, np.sqrt(sigma))
                    beta = 1.0
                    u_a = state.u_avgcon if bool(state.avg_criterion) else state.u
                    v_a = state.v_avgcon if bool(state.avg_criterion) else state.v
                    beta = float(self._bb_beta(u_a, v_a,
                                               jnp.asarray(mu, self.dtype)))
                    state = self._reinit_scale(state, np.sqrt(1.0 / sigma))

        if old_handler is not None:
            signal.signal(signal.SIGINT, old_handler)
        if interrupted and status == Status.UNFINISHED:
            status = Status.SIGINT

        solve_time = time.perf_counter() - t0
        sol = self._extract_solution(
            state, res_np, status, ipm_iter, admm_total, solve_time
        )
        log.footer(sol.status_name, {
            "pobj": sol.pobj, "dobj": sol.dobj,
            "res_pri": sol.res_pri, "res_dual": sol.res_dual,
            "rel_gap": sol.rel_gap,
            "ipm_iters": sol.ipm_iters, "admm_iters": sol.admm_iters,
            "setup_time": sol.setup_time, "solve_time": sol.solve_time,
            "avg_cg_iters": sol.avg_cg_iters,
        }, timers)
        return sol

    def _reinit(self, state: InnerState, sigma):
        """`reinitialize_vars(w, 0)` on the active iterate."""
        m = self.m
        sig = jnp.asarray(sigma, self.dtype)

        def reb(u, v):
            return hsd.reinit_rebalance(u, v, sig, m)

        if bool(state.avg_criterion):
            u, v = reb(state.u_avgcon, state.v_avgcon)
            return state._replace(u_avgcon=u, v_avgcon=v)
        u, v = reb(state.u, state.v)
        return state._replace(u=u, v=v)

    def _reinit_scale(self, state: InnerState, factor):
        """`reinitialize_vars` modes 1/2 (`abip.c:1057-1072`): scale the
        barrier coordinates of the active iterate by `factor`."""
        m = self.m
        f = jnp.asarray(factor, self.dtype)

        def scl(u, v):
            return u.at[m:].multiply(f), v.at[m:].multiply(f)

        if bool(state.avg_criterion):
            u, v = scl(state.u_avgcon, state.v_avgcon)
            return state._replace(u_avgcon=u, v_avgcon=v)
        u, v = scl(state.u, state.v)
        return state._replace(u=u, v=v)

    def _extract_solution(self, state, res_np, status, ipm_iter, admm_total,
                          solve_time) -> LPSolution:
        """`get_solution` (`abip.c:1344-1414`) + un-normalization
        (`normalize.c:133-158`)."""
        m, n, l = self.m, self.n, self.l
        stgs = self.stgs
        avg = bool(state.avg_criterion)
        u = np.asarray(state.u_avgcon if avg else state.u)
        v = np.asarray(state.v_avgcon if avg else state.v)
        if res_np is None:
            r = self._calc_residuals(
                state.u_avgcon if avg else state.u,
                state.v_avgcon if avg else state.v,
            )
            res_np = jax.tree.map(float, r)._asdict()

        x = u[m : m + n].copy()
        y = u[:m].copy()
        s = v[m : m + n].copy()
        tau = res_np["tau"]
        kap = res_np["kap"]
        bty = res_np["bt_y_by_tau"]
        ctx = res_np["ct_x_by_tau"]

        if status == Status.UNFINISHED:
            if tau > INDETERMINATE_TOL and tau > kap:
                status = Status.SOLVED_INACCURATE
                x, y, s = x / max(tau, EPS_TOL), y / max(tau, EPS_TOL), s / max(tau, EPS_TOL)
            elif np.linalg.norm(u) < INDETERMINATE_TOL * np.sqrt(l):
                status = Status.INDETERMINATE
                x[:], y[:], s[:] = np.nan, np.nan, np.nan
            elif -bty < ctx:
                status = Status.INFEASIBLE_INACCURATE
                y, s = y / bty, s / bty
                x[:] = np.nan
            else:
                status = Status.UNBOUNDED_INACCURATE
                x = x / (-ctx)
                y[:], s[:] = np.nan, np.nan
        elif status == Status.SIGINT:
            # best-effort solution at interrupt time
            x, y, s = x / max(tau, EPS_TOL), y / max(tau, EPS_TOL), s / max(tau, EPS_TOL)
        elif status == Status.SOLVED:
            x, y, s = x / max(tau, EPS_TOL), y / max(tau, EPS_TOL), s / max(tau, EPS_TOL)
        elif status == Status.INFEASIBLE:
            y, s = y / bty, s / bty
            x[:] = np.nan
        elif status == Status.UNBOUNDED:
            x = x / (-ctx)
            y[:], s[:] = np.nan, np.nan

        if stgs.normalize:
            D = np.asarray(self.scal.D)
            E = np.asarray(self.scal.E)
            sc_b = float(self.sc_b)
            sc_c = float(self.sc_c)
            x = x / (E * sc_b)
            y = y / (D * sc_c)
            s = s * E / (sc_c * stgs.scale)

        solved_like = status in (Status.SOLVED, Status.SOLVED_INACCURATE,
                                 Status.SIGINT)
        pobj = ctx / tau if (solved_like and tau > EPS_TOL) else (
            -np.inf if status in (Status.UNBOUNDED, Status.UNBOUNDED_INACCURATE) else np.inf
        )
        dobj = bty / tau if (solved_like and tau > EPS_TOL) else pobj

        return LPSolution(
            x=x, y=y, s=s,
            status=int(status),
            status_name=Status.name(status),
            pobj=float(pobj), dobj=float(dobj),
            res_pri=res_np["res_pri"], res_dual=res_np["res_dual"],
            rel_gap=res_np["rel_gap"],
            res_infeas=res_np["res_infeas"], res_unbdd=res_np["res_unbdd"],
            ipm_iters=ipm_iter + 1, admm_iters=admm_total,
            setup_time=self.setup_time, solve_time=solve_time,
            avg_cg_iters=float(state.cg_iters) / max(1, admm_total),
        )


def solve_lp(A, b, c, settings: Settings = Settings(), **overrides) -> LPSolution:
    """One-call LP solve: min c'x s.t. Ax = b, x >= 0.

    Equivalent of the reference `ABIP(main)` (`abip.c:2393-2422`).
    """
    if overrides:
        import dataclasses

        settings = dataclasses.replace(settings, **overrides)
    w = LPWorkspace(A, b, c, settings)
    return w.solve()
