"""ABIP conic / quadratic cone programming driver.

Solves   min (1/2) x'Qx + c'x   s.t.  Ax = b,  x in K
with K a product of {zero, free, nonneg, SOC, RSOC} cones.

Device-first re-design of the reference conic core
(`/root/reference/src/abip-qcp/source/abip.c`): the Douglas-Rachford inner
loop -- Schur-complement projection with the quadratic-formula tau step,
segment-vectorized cone barrier prox, dual update, inner HSD-operator
check, cadenced residual checks -- is ONE jitted `lax.while_loop`; the
outer loop (barrier schedule `adjust_barrier`, `source/abip.c:994-1071`)
runs on the host, one sync per barrier stage.

LP is the special case Q=0, K=R+^n -- but the dedicated `lp.py` driver
keeps the reference's LP-specialized economies (rank-1 HSD correction,
restart/averaging, hybrid mu schedules).
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .cones import ConeSpec, ConeLayout
from .linsys.schur import DenseSchurSolver, CGSchurSolver
from .problem import LinearOperator
from .scaling import equilibrate_conic, ConicScalingData
from .settings import Settings, Status

EPS_TOL = 1e-18


def conic_defaults(**overrides) -> Settings:
    """Conic defaults (`src/abip-qcp/source/util.c:203-255`): rho_y=1e-6."""
    base = dict(rho_y=1e-6, rho_x=1.0, rho_tau=1.0, psi=1.0,
                origin_rescale=True, pc_ruiz_rescale=True, qp_rescale=False)
    base.update(overrides)
    return Settings(**base)


from . import conic_ops
from .conic_ops import ConicResiduals  # re-exported for compatibility


class ConicInnerState(NamedTuple):
    u: jnp.ndarray
    v: jnp.ndarray
    v_origin: jnp.ndarray
    j: jnp.ndarray
    k: jnp.ndarray
    err_inner: jnp.ndarray
    status: jnp.ndarray
    res: ConicResiduals
    cg_iters: jnp.ndarray


@dataclass
class ConicSolution:
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


def _step_fns(A_op, solver, Q, Q_diag, b, c, rho, r_vec, a_coef, layout,
              D, E, sc_b, sc_c, nm_inf_b, nm_inf_c, stgs):
    """Build the per-stage step functions from explicit data.

    Called in two ways: (a) by the module-level shape-shared jitted
    drivers below with all arrays as traced ARGUMENTS (dense path -- one
    compile per shape, shared across instances), and (b) by
    `ConicWorkspace._build_kernels` with workspace closures for the
    matrix-free / CG path (where custom operators cannot be jit inputs).
    """
    m = b.shape[0]
    n = c.shape[0]
    alpha = stgs.alpha
    rho_tail = rho[m:]  # (n+1,): x block + tau

    def Q_times(x):
        if Q is not None:
            return Q @ x
        if Q_diag is not None:
            return Q_diag * x
        return jnp.zeros_like(x)

    def solve_fn(w_y, w_x, k, warm, err):
        return solver.solve(w_y, w_x, iter_count=k, warm_start=warm,
                            tol_hint=err)

    def projection(u, v, k, err):
        return conic_ops.projection(u, v, solve_fn, rho, r_vec, a_coef,
                                    Q_times, m, n, k, err_ratio=err)

    def barrier_and_dual(u, v, u_t, lam):
        return conic_ops.barrier_and_dual(u, v, u_t, lam, rho_tail,
                                          layout, alpha, m, n)

    def inner_conv_check(u, v_origin):
        return conic_ops.inner_conv_check(u, v_origin, A_op.matvec,
                                          A_op.rmatvec, Q_times, b, c,
                                          m, n)

    obj_scale = (stgs.scale if stgs.normalize else 1.0)

    def calc_residuals(u, v_origin, prev: ConicResiduals):
        return conic_ops.conic_residuals(
            u, v_origin, prev, A_op.matvec, A_op.rmatvec, Q_times, b, c,
            D, E, sc_b, sc_c, obj_scale, nm_inf_b, nm_inf_c,
            stgs.eps_p, stgs.eps_d, stgs.eps_g, m, n,
        )

    def has_converged(r: ConicResiduals, total_pos):
        return conic_ops.conic_converged_code(
            r, stgs.eps_p, stgs.eps_d, stgs.eps_g, stgs.eps_inf,
            stgs.eps_unb, stgs.err_dif, total_pos,
        )

    def inner_body(state: ConicInnerState, mu, beta, tol_inner, ipm_i, k_cap):
        u_t, its = projection(state.u, state.v, state.k,
                              state.res.error_ratio)
        lam = mu / beta
        u, v = barrier_and_dual(state.u, state.v, u_t, lam)
        v_origin = rho * v
        k = state.k + 1
        err_inner = inner_conv_check(u, v_origin)

        # cadenced residual check (`source/abip.c:1170-1207`)
        do_check = ((state.j + 1) % stgs.inner_check_period == 0) | (
            state.res.error_ratio <= 8.0
        )

        def check(_):
            r = calc_residuals(u, v_origin, state.res)
            st = has_converged(r, (ipm_i > 0) & (k > 0))
            return r, st

        def no_check(_):
            return state.res, jnp.zeros((), jnp.int32)

        res, status = jax.lax.cond(do_check, check, no_check, operand=None)
        return ConicInnerState(
            u=u, v=v, v_origin=v_origin, j=state.j + 1, k=k,
            err_inner=err_inner, status=status, res=res,
            cg_iters=state.cg_iters + its,
        )

    def run_inner(state: ConicInnerState, mu, beta, tol_inner, ipm_i,
                  k_cap, j_cap):
        # j_cap is traced: the host runs one stage as several bounded
        # sprints so SIGINT and max_time are checked between sprints
        # (the reference checks time inline each iteration,
        # `source/abip.c:1152,1182`)
        def cond(s: ConicInnerState):
            return (
                (s.j < j_cap)
                & (s.err_inner >= tol_inner)
                & (s.status == 0)
                & (s.k < k_cap)
            )

        def body(s):
            return inner_body(s, mu, beta, tol_inner, ipm_i, k_cap)

        return jax.lax.while_loop(cond, body, state)

    return run_inner, calc_residuals, has_converged


class _SharedData(NamedTuple):
    """Instance arrays for the shape-shared jitted drivers (a pytree)."""

    solver: object            # DenseSchurSolver (registered pytree)
    Q: Optional[jnp.ndarray]
    Q_diag: Optional[jnp.ndarray]
    b: jnp.ndarray
    c: jnp.ndarray
    rho: jnp.ndarray
    r_vec: jnp.ndarray
    a_coef: jnp.ndarray
    D: jnp.ndarray
    E: jnp.ndarray
    sc_b: jnp.ndarray
    sc_c: jnp.ndarray
    nm_inf_b: jnp.ndarray
    nm_inf_c: jnp.ndarray


def _shared_fns(data: _SharedData, cones, stgs):
    return _step_fns(LinearOperator.from_dense(data.solver.A), data.solver,
                     data.Q, data.Q_diag, data.b, data.c, data.rho,
                     data.r_vec, data.a_coef, ConeLayout(cones),
                     data.D, data.E, data.sc_b, data.sc_c,
                     data.nm_inf_b, data.nm_inf_c, stgs)


@partial(jax.jit, static_argnames=("cones", "stgs"))
def _run_inner_shared(data: _SharedData, state, mu, beta, tol_inner, ipm_i,
                      k_cap, j_cap, *, cones, stgs):
    """One barrier-stage sprint, compiled ONCE PER SHAPE.

    Instance data enters as pytree arguments (not closure constants), so
    every same-shape instance with the same settings reuses the compiled
    executable -- the per-instance closure-jit pattern paid ~0.8s of XLA
    compile per conic solve on suites of identical shapes (measured)."""
    run_inner, _, _ = _shared_fns(data, cones, stgs)
    return run_inner(state, mu, beta, tol_inner, ipm_i, k_cap, j_cap)


@partial(jax.jit, static_argnames=("cones", "stgs"))
def _calc_residuals_shared(data: _SharedData, u, v_origin, prev, *,
                           cones, stgs):
    _, calc_residuals, _ = _shared_fns(data, cones, stgs)
    return calc_residuals(u, v_origin, prev)


@partial(jax.jit, static_argnames=("cones", "stgs"))
def _dense_setup_shared(A, b, c, Q, Q_diag, *, cones, stgs):
    """Compiled-per-shape dense workspace setup.

    Equilibration, Schur factorization, and the r-vector solve
    (`pre_calculate`, `source/abip.c:886-910`) were previously ~50
    eager dispatches totalling ~50ms per tiny instance (45% of wall on
    the dim-204 suite class) -- as one jitted function they fuse and
    compile once per shape, like the inner-loop drivers."""
    dtype = A.dtype
    m, n = A.shape
    layout = ConeLayout(cones)

    nm_inf_b = jnp.max(jnp.abs(b)) if m else jnp.zeros((), dtype)
    nm_inf_c = jnp.max(jnp.abs(c))

    if stgs.normalize:
        # a diagonal Q rides the equilibration directly so E sees its
        # magnitudes (`qcp_config.c:239-248`; parity-relevant)
        q_arg = Q if Q is not None else Q_diag
        A, q_out, b, c, scal = equilibrate_conic(A, q_arg, b, c, layout,
                                                 stgs)
        if Q is not None:
            Q = q_out
        elif Q_diag is not None:
            Q_diag = q_out
    else:
        scal = ConicScalingData(
            D=jnp.ones((m,), dtype), E=jnp.ones((n,), dtype),
            sc_b=jnp.ones((), dtype), sc_c=jnp.ones((), dtype))

    rho = jnp.concatenate([
        jnp.full((m,), stgs.rho_y, dtype),
        jnp.full((n,), stgs.rho_x, dtype),
        jnp.full((1,), stgs.rho_tau, dtype),
    ])
    # 1-D Q_diag passes through so DenseSchurSolver can take its
    # Woodbury (m x m) form; dense Q keeps the primal (n x n) form
    solver = DenseSchurSolver(A, Q if Q is not None else Q_diag,
                              rho[:m], rho[m : m + n],
                              mode=stgs.dense_mode)
    r_y, r_x, _ = solver.solve(-b, c, iter_count=-1)
    r_vec = jnp.concatenate([r_y, r_x])
    a_coef = stgs.rho_tau + jnp.dot(rho[: m + n] * r_vec, r_vec)
    return (A, Q, Q_diag, b, c, scal, rho, solver, r_vec, a_coef,
            nm_inf_b, nm_inf_c)


class ConicWorkspace:
    """Setup-once conic workspace (`ABIP(init)`, `source/abip.c:1271-1311`)."""

    def __init__(self, A, b, c, cones: ConeSpec, Q=None,
                 settings: Optional[Settings] = None, tol_ladder=None,
                 solver_factory=None):
        settings = (settings or conic_defaults()).resolved()
        settings.validate()
        t0 = time.perf_counter()
        self.stgs = settings
        dtype = jnp.dtype(settings.dtype)
        self.dtype = dtype

        # A may be a dense array OR a matrix-free LinearOperator (the
        # reference's `spe_A_times` path, e.g. LASSO's reformulated matrix
        # that is never materialized, `lasso_config.c:99-126`).
        matrix_free = isinstance(A, LinearOperator)
        if matrix_free:
            if settings.normalize:
                raise ValueError(
                    "matrix-free operators require normalize=False (provide "
                    "pre-scaled data, as the reference app configs do)"
                )
            if settings.linsys == "dense":
                raise ValueError("matrix-free operators require linsys='cg'")
            m, n = A.m, A.n
            self.A_op = A
            A_dense = None
        else:
            A = jnp.asarray(A, dtype)
            m, n = A.shape
            A_dense = A
        b = jnp.asarray(b, dtype)
        c = jnp.asarray(c, dtype)
        Q = jnp.asarray(Q, dtype) if Q is not None else None
        if b.shape != (m,):
            raise ValueError(f"b must have shape ({m},); got {b.shape}")
        if c.shape != (n,):
            raise ValueError(f"c must have shape ({n},); got {c.shape}")
        # finite-data validation (`validate`, `source/abip.c` init path):
        # NaN data otherwise hangs the inner loop (no convergence, no
        # certificate -- every comparison with NaN is False)
        if A_dense is not None and not bool(
                jnp.all(jnp.isfinite(A_dense))):
            raise ValueError("A contains NaN or infinite entries")
        if not bool(jnp.all(jnp.isfinite(b))):
            raise ValueError("b contains NaN or infinite entries")
        if not bool(jnp.all(jnp.isfinite(c))):
            raise ValueError("c contains NaN or infinite entries")
        if Q is not None and not bool(jnp.all(jnp.isfinite(Q))):
            raise ValueError("Q contains NaN or infinite entries")
        # Q: full (n, n) matrix or 1-D diagonal (the SVM-QP case,
        # `svm_qp_config.c:8-60` builds an explicit diagonal Q)
        self.Q_diag = None
        if Q is not None and Q.ndim == 1:
            if Q.shape != (n,):
                raise ValueError(f"diagonal Q must have shape ({n},); got {Q.shape}")
            self.Q_diag = Q
            Q = None
        elif Q is not None and Q.shape != (n, n):
            raise ValueError(f"Q must have shape ({n},{n}); got {Q.shape}")
        cones.validate_dim(n)
        self.m, self.n = m, n
        self.l = m + n + 1
        self.layout = ConeLayout(cones)
        self.has_Q = Q is not None or self.Q_diag is not None

        use_cg = (
            matrix_free
            or settings.linsys == "cg"
            or (settings.linsys == "auto" and n > 4096)
        )
        if (not use_cg and settings.dense_mode == "inverse_mixed"
                and settings.rho_y < 1e-4 and n >= 500):
            # measured: inverse_mixed at conic defaults (rho_y=1e-6)
            # stalled a dim-1020 instance for 85k iterations --
            # cond(S) ~ 1/rho_y exceeds what the mode's 3 IR steps
            # against the f32 inverse can recover at this size
            import warnings

            warnings.warn(
                "dense_mode='inverse_mixed' with rho_y < 1e-4 on a "
                f"dim-{n} system may stall (cond(S) ~ "
                f"{1 / settings.rho_y:.0e} exceeds the f32-inverse IR "
                "budget); prefer dense_mode='chol' or rho_y >= 1e-3",
                stacklevel=2)

        if not use_cg:
            # dense path: one compiled-per-shape setup program
            (self.A, self.Q, self.Q_diag, self.b, self.c, self.scal,
             self.rho, self.solver, self.r_vec, self.a_coef,
             self.nm_inf_b, self.nm_inf_c) = _dense_setup_shared(
                A_dense, b, c, Q, self.Q_diag,
                cones=self.layout.spec, stgs=settings)
            self.A_op = LinearOperator.from_dense(self.A)
            self._build_kernels()
            self.setup_time = time.perf_counter() - t0
            return

        # inf-norms of ORIGINAL data (`init_work`, `source/abip.c:873-874`)
        self.nm_inf_b = jnp.max(jnp.abs(b)) if m else jnp.zeros((), dtype)
        self.nm_inf_c = jnp.max(jnp.abs(c))

        if settings.normalize and not matrix_free:
            # a diagonal Q rides the equilibration directly so E sees its
            # magnitudes (`qcp_config.c:239-248`; parity-relevant)
            q_arg = Q if Q is not None else self.Q_diag
            A_dense, q_out, b, c, scal = equilibrate_conic(
                A_dense, q_arg, b, c, self.layout, settings)
            if Q is not None:
                Q = q_out
            elif self.Q_diag is not None:
                self.Q_diag = q_out
        else:
            scal = ConicScalingData(
                D=jnp.ones((m,), dtype), E=jnp.ones((n,), dtype),
                sc_b=jnp.ones((), dtype), sc_c=jnp.ones((), dtype))
        self.scal = scal
        self.Q, self.b, self.c = Q, b, c
        if not matrix_free:
            self.A = A_dense
            self.A_op = LinearOperator.from_dense(A_dense)
        else:
            self.A = None

        # DR scaling rho_dr = (rho_y 1_m, rho_x 1_n, rho_tau)
        # (`init_qcp`, `qcp_config.c:26-36`)
        self.rho = jnp.concatenate([
            jnp.full((m,), settings.rho_y, dtype),
            jnp.full((n,), settings.rho_x, dtype),
            jnp.full((1,), settings.rho_tau, dtype),
        ])

        ry = self.rho[:m]
        rx = self.rho[m : m + n]
        # Jacobi preconditioner diag(S) (`init_qcp_precon`,
        # `qcp_config.c:754-780`); matrix-free operators may supply
        # their column norms (`col_norms_sq`), like the custom
        # preconditioners of `lasso_config.c:571-587`.
        if matrix_free:
            col_sq = getattr(self.A_op, "col_norms_sq", None)
            diag_S = rx + (
                jnp.asarray(col_sq) / settings.rho_y
                if col_sq is not None else jnp.zeros((n,), dtype)
            )
        else:
            diag_S = rx + jnp.sum(A_dense * A_dense / ry[:, None], axis=0)
        if Q is not None:
            diag_S = diag_S + jnp.diag(Q)
        elif self.Q_diag is not None:
            diag_S = diag_S + self.Q_diag
        if Q is not None:
            Q_op = lambda x: Q @ x  # noqa: E731
        elif self.Q_diag is not None:
            qd = self.Q_diag
            Q_op = lambda x: qd * x  # noqa: E731
        else:
            Q_op = None
        if solver_factory is not None:
            # per-problem custom KKT backend (the `spe_problem` vtable's
            # init_spe_linsys_work/solve_spe_linsys seam,
            # `include/abip.h:29-60`): e.g. the SVM operators' exact
            # diag + low-rank Gram (`linsys.schur.LowRankWoodburySolver`)
            self.solver = solver_factory(self.A_op, ry, rx,
                                         self.Q_diag if Q is None else Q)
        else:
            self.solver = CGSchurSolver(self.A_op, Q_op, ry, rx, diag_S,
                                        max_iters=settings.cg_max_iters,
                                        tol_ladder=tol_ladder)

        # r = Ktilde^-1 (-b; c), a = rho_tau + <rho . r, r>
        # (`pre_calculate`, `source/abip.c:886-910`)
        r_y, r_x, _ = self.solver.solve(-b, c, iter_count=-1)
        self.r_vec = jnp.concatenate([r_y, r_x])
        self.a_coef = settings.rho_tau + jnp.dot(
            self.rho[: m + n] * self.r_vec, self.r_vec
        )

        self._build_kernels()
        self.setup_time = time.perf_counter() - t0

    # ------------------------------------------------------------------ #
    def _build_kernels(self):
        stgs = self.stgs

        if isinstance(self.solver, DenseSchurSolver):
            # shape-shared path: data rides as pytree arguments into the
            # module-level jitted drivers, so same-shape instances reuse
            # one compiled executable (see `_run_inner_shared`)
            data = _SharedData(
                solver=self.solver, Q=self.Q, Q_diag=self.Q_diag,
                b=self.b, c=self.c, rho=self.rho, r_vec=self.r_vec,
                a_coef=self.a_coef, D=self.scal.D, E=self.scal.E,
                sc_b=self.scal.sc_b, sc_c=self.scal.sc_c,
                nm_inf_b=self.nm_inf_b, nm_inf_c=self.nm_inf_c,
            )
            cones = self.layout.spec

            self._run_inner = lambda *args: _run_inner_shared(
                data, *args, cones=cones, stgs=stgs)
            self._calc_residuals = lambda u, vo, prev: _calc_residuals_shared(
                data, u, vo, prev, cones=cones, stgs=stgs)
            _, _, self._has_converged = _shared_fns(data, cones, stgs)
            return

        # matrix-free / CG path: custom operators cannot be jit inputs,
        # so the kernels stay per-instance closures (compiled per
        # instance, as before)
        run_inner, calc_residuals, has_converged = _step_fns(
            self.A_op, self.solver, self.Q, self.Q_diag, self.b, self.c,
            self.rho, self.r_vec, self.a_coef, self.layout,
            self.scal.D, self.scal.E, self.scal.sc_b, self.scal.sc_c,
            self.nm_inf_b, self.nm_inf_c, stgs,
        )
        self._run_inner = jax.jit(run_inner)
        self._calc_residuals = jax.jit(
            lambda u, v_origin, prev: calc_residuals(u, v_origin, prev)
        )
        self._has_converged = has_converged

    # ------------------------------------------------------------------ #
    def _adjust_barrier(self, mu, res_np):
        """`adjust_barrier` (`source/abip.c:994-1071`) via the shared
        bucket tables (`conic_ops.adjust_barrier_device`)."""
        stgs = self.stgs
        eps_min = min(stgs.eps_p, stgs.eps_d, stgs.eps_g)
        mu_new, tol = conic_ops.adjust_barrier_device(
            jnp.asarray(mu), jnp.asarray(res_np["error_ratio"]),
            eps_min, stgs.psi,
        )
        return float(mu_new), float(tol)

    def update_problem(self, b, c) -> "ConicWorkspace":
        """Re-target this workspace at new b, c with the SAME A, Q, cones.

        Conic analogue of `LPWorkspace.update_problem` -- the reference
        splits `ABIP(init)`/`ABIP(solve)` so one factorization serves
        repeated solves (`source/abip.c:1271-1311`).  The cached Schur
        factor/preconditioner and the compiled kernels are reused; only
        the b/c-derived quantities (scaled b, c, r_vec, a_coef, inf-norms)
        are recomputed -- one extra linsys solve.
        """
        stgs = self.stgs
        dtype = self.dtype
        m, n = self.m, self.n
        b = jnp.asarray(b, dtype)
        c = jnp.asarray(c, dtype)
        if b.shape != (m,) or c.shape != (n,):
            raise ValueError(f"b/c must have shapes ({m},)/({n},)")
        self.nm_inf_b = jnp.max(jnp.abs(b)) if m else jnp.zeros((), dtype)
        self.nm_inf_c = jnp.max(jnp.abs(c))
        if stgs.normalize:
            # sc from the new un-equilibrated b, c (`qcp_config.c:462-463`)
            from .scaling import MAX_SCALE, MIN_SCALE

            sc = jnp.sqrt(jnp.sqrt(jnp.sum(c * c) + jnp.sum(b * b)))
            sc = jnp.where(sc < MIN_SCALE, 1.0, jnp.minimum(sc, MAX_SCALE))
            sc_b = 1.0 / sc
            sc_c = 1.0 / sc
            b = b / self.scal.D * (sc_b * stgs.scale)
            c = c / self.scal.E * (sc_c * stgs.scale)
            self.scal = self.scal._replace(sc_b=sc_b, sc_c=sc_c)
        self.b, self.c = b, c
        r_y, r_x, _ = self.solver.solve(-b, c, iter_count=-1)
        self.r_vec = jnp.concatenate([r_y, r_x])
        self.a_coef = stgs.rho_tau + jnp.dot(
            self.rho[: m + n] * self.r_vec, self.r_vec
        )
        self._build_kernels()
        return self

    def shard(self, mesh, axis: str = "rows") -> "ConicWorkspace":
        """Distribute this conic workspace over a device mesh: the FULL
        DR/ADMM loop then iterates distributed (the conic counterpart of
        `LPWorkspace.shard`; same GSPMD design at the reference's
        `solve_linsys` seam, `source/linsys.c:1141-1176`).

        Requires the matrix-free CG Schur path (`linsys='cg'`) with a
        dense A: A is placed block-row sharded and the unchanged jitted
        kernels run under XLA's SPMD partitioner, which inserts psum at
        every `A'(.)` product and CG reduction.  Dense cached factors are
        not shardable (a row-sharded triangular/inverse factor gathers on
        every apply -- measured on the LP side in round 1).
        """
        from jax.sharding import NamedSharding, PartitionSpec as P

        if not isinstance(self.solver, CGSchurSolver):
            raise ValueError(
                "shard() requires the CG Schur path; rebuild the "
                "workspace with settings.linsys='cg'")
        if self.A is None:
            raise ValueError(
                "shard() requires a dense A (matrix-free operators carry "
                "their own distribution)")
        ndev = mesh.devices.size
        if self.m % ndev != 0:
            raise ValueError(
                f"m={self.m} must be divisible by the mesh size {ndev}")

        A_sh = jax.device_put(self.A, NamedSharding(mesh, P(axis, None)))
        row = NamedSharding(mesh, P(axis))
        self.A = A_sh
        self.A_op = LinearOperator.from_dense(A_sh)
        self.solver.A_op = self.A_op
        self.solver.ry_inv = jax.device_put(self.solver.ry_inv, row)
        self.b = jax.device_put(self.b, row)
        self._build_kernels()
        return self

    def _warm_start(self, warm, mu, beta):
        """Seed u, v from caller-provided (x, y, s) in original units,
        cone-interiorized (see `ConeLayout.interiorize`)."""
        x, y, s = (np.asarray(a, float) for a in warm)
        m, n = self.m, self.n
        if x.shape != (n,) or y.shape != (m,) or s.shape != (n,):
            raise ValueError("warm start must be (x (n,), y (m,), s (n,))")
        D = np.asarray(self.scal.D)
        E = np.asarray(self.scal.E)
        sc_b = float(self.scal.sc_b)
        sc_c = float(self.scal.sc_c)
        # invert the un-scaling of `_extract_solution`
        x_s = x * (E * sc_b)
        y_s = y * (D * sc_c)
        s_s = s * (sc_c * self.stgs.scale) / E
        floor = float(np.sqrt(mu / beta) * 1e-3)
        u = jnp.asarray(
            np.concatenate([y_s, self.layout.interiorize(x_s, floor),
                            [1.0]]), self.dtype)
        v = jnp.asarray(
            np.concatenate([np.zeros(m),
                            self.layout.interiorize(s_s, floor, dual=True),
                            [floor]]), self.dtype)
        return u, v

    def solve(self, warm=None, resume=None, checkpoint_path=None,
              checkpoint_every=0) -> ConicSolution:
        """Run the solver.

        warm: optional (x, y, s) in original units to seed the iterate.
        resume: optional `ConicCheckpoint` to continue a prior solve.
        checkpoint_path/checkpoint_every: save state every k outer
        iterations (plus once at exit) to `checkpoint_path`.
        """
        from .utils import IterationLog, PhaseTimers, solver_banner
        from .utils.checkpoint import ConicCheckpoint

        stgs = self.stgs
        m, n, l = self.m, self.n, self.l
        t0 = time.perf_counter()
        log = IterationLog(enabled=stgs.verbose)
        timers = PhaseTimers()
        if stgs.verbose:
            nnz = int(jnp.sum(self.A != 0)) if self.A is not None else self.A_op.nnz
            print(solver_banner("conic", m, n, nnz,
                                type(self.solver).__name__))

        mu, beta = 1.0, 1.0
        tol_inner = 4.0 * mu ** stgs.psi
        i0 = 0
        if resume is not None:
            u = jnp.asarray(resume.u, self.dtype)
            v = jnp.asarray(resume.v, self.dtype)
            mu, tol_inner = resume.mu, resume.tol_inner
            i0 = resume.ipm_iters
        elif warm is not None:
            u, v = self._warm_start(warm, mu, beta)
        else:
            # cone-aware cold start (`update_work`, `source/abip.c:912-992`)
            x0 = self.layout.interior_point(self.dtype)
            u = jnp.concatenate([jnp.zeros((m,), self.dtype), x0,
                                 jnp.ones((1,), self.dtype)])
            v = u

        state = ConicInnerState(
            u=u, v=v, v_origin=self.rho * v,
            j=jnp.zeros((), jnp.int32), k=jnp.zeros((), jnp.int32),
            err_inner=jnp.full((), jnp.inf, self.dtype),
            status=jnp.zeros((), jnp.int32),
            res=ConicResiduals.init(self.dtype),
            cg_iters=jnp.zeros((), jnp.int32),
        )
        if resume is not None:
            state = state._replace(
                k=jnp.asarray(resume.admm_iters, jnp.int32))
        k_cap = stgs.max_admm_iters * stgs.max_ipm_iters
        status = Status.UNFINISHED
        ipm_iter = i0
        res_np = None
        # sprint length: SIGINT/max_time response granularity
        chunk = max(1, stgs.inner_check_period) * 10

        # SIGINT listener (`ctrlc.c:62-92` pattern, shared with the LP
        # driver): ctrl-C sets a flag, checked between sprints.
        import signal

        interrupted = False

        def _on_sigint(signum, frame):
            nonlocal interrupted
            interrupted = True

        try:
            old_handler = signal.signal(signal.SIGINT, _on_sigint)
        except ValueError:          # not the main thread
            old_handler = None

        timed_out = False
        for i in range(i0, stgs.max_ipm_iters):
            ipm_iter = i
            if interrupted:
                status = Status.SIGINT
                break
            state = state._replace(
                j=jnp.zeros((), jnp.int32),
                err_inner=jnp.full((), jnp.inf, self.dtype),
                status=jnp.zeros((), jnp.int32),
            )
            # one barrier stage = several bounded sprints, so SIGINT and
            # max_time stay responsive inside long stages
            j_host = 0
            while True:
                j_cap = min(stgs.max_admm_iters, j_host + chunk)
                with timers.phase("inner_admm"):
                    state = self._run_inner(
                        state,
                        jnp.asarray(mu, self.dtype),
                        jnp.asarray(beta, self.dtype),
                        jnp.asarray(tol_inner, self.dtype),
                        jnp.asarray(i, jnp.int32),
                        jnp.asarray(k_cap, jnp.int32),
                        jnp.asarray(j_cap, jnp.int32),
                    )
                    # ONE gathered transfer per sprint (each separate
                    # int()/float() costs a device->host round-trip)
                    j_host, err_host, st_host, k_host = (
                        x.item() for x in jax.device_get(
                            (state.j, state.err_inner,
                             state.status, state.k)))
                timed_out = time.perf_counter() - t0 > stgs.max_time
                if (
                    interrupted
                    or timed_out
                    or err_host < tol_inner
                    or st_host != 0
                    or j_host >= stgs.max_admm_iters
                    or k_host >= k_cap
                ):
                    break
            if interrupted:
                status = Status.SIGINT
                break
            inner_status = st_host
            if inner_status != 0:
                status = inner_status
                res_np = jax.tree.map(float, state.res)._asdict()
                break

            # outer residual check (`source/abip.c:1212-1243`)
            with timers.phase("residuals"):
                r = self._calc_residuals(state.u, state.v_origin, state.res)
                res_np = jax.tree.map(float, r)._asdict()
            state = state._replace(res=r)
            log.row(i, k_host, mu, res_np,
                    res_np["pobj"], res_np["dobj"])
            status = int(self._has_converged(
                r, jnp.asarray((i > 0) and k_host > 0)))
            if (
                status != 0
                or k_host + 1 >= k_cap
                or timed_out
            ):
                break

            mu, tol_inner = self._adjust_barrier(mu, res_np)
            if checkpoint_path and checkpoint_every and \
                    (i + 1) % checkpoint_every == 0:
                ConicCheckpoint(
                    u=np.asarray(state.u), v=np.asarray(state.v),
                    mu=mu, tol_inner=tol_inner,
                    admm_iters=int(state.k), ipm_iters=i + 1,
                ).save(checkpoint_path)

        if old_handler is not None:
            signal.signal(signal.SIGINT, old_handler)
        if interrupted and status == Status.UNFINISHED:
            status = Status.SIGINT
        if checkpoint_path:
            ConicCheckpoint(
                u=np.asarray(state.u), v=np.asarray(state.v),
                mu=mu, tol_inner=tol_inner,
                admm_iters=int(state.k), ipm_iters=ipm_iter + 1,
            ).save(checkpoint_path)

        sol = self._extract_solution(state, res_np, status, ipm_iter, t0)
        log.footer(sol.status_name, {
            "pobj": sol.pobj, "dobj": sol.dobj,
            "res_pri": sol.res_pri, "res_dual": sol.res_dual,
            "rel_gap": sol.rel_gap,
            "ipm_iters": sol.ipm_iters, "admm_iters": sol.admm_iters,
            "setup_time": sol.setup_time, "solve_time": sol.solve_time,
            "avg_cg_iters": sol.avg_cg_iters,
        }, timers)
        return sol

    def _extract_solution(self, state, res_np, status, ipm_iter, t0):
        """`get_solution` (`source/abip.c:559-587`) + un-scaling
        (`un_scaling_qcp_sol`, `qcp_config.c:496-513`)."""
        m, n = self.m, self.n
        stgs = self.stgs
        u = np.asarray(state.u)
        v = np.asarray(state.v)
        if res_np is None:
            res_np = jax.tree.map(
                float, self._calc_residuals(state.u, state.v_origin, state.res)
            )._asdict()
        tau = max(res_np["tau"], EPS_TOL)

        x = u[m : m + n].copy()
        y = u[:m].copy()
        s = v[m : m + n].copy()

        if status in (Status.INFEASIBLE, Status.INFEASIBLE_INACCURATE):
            bty = res_np["dobj"] * res_np["tau"]
            y, s = y / bty, s / bty
            x[:] = np.nan
        elif status in (Status.UNBOUNDED, Status.UNBOUNDED_INACCURATE):
            ctx = res_np["pobj"] * res_np["tau"]
            x = x / (-ctx)
            y[:], s[:] = np.nan, np.nan
        else:
            if status == Status.UNFINISHED:
                status = Status.SOLVED_INACCURATE
            x, y, s = x / tau, y / tau, s / tau

        if stgs.normalize:
            D = np.asarray(self.scal.D)
            E = np.asarray(self.scal.E)
            sc_b = float(self.scal.sc_b)
            sc_c = float(self.scal.sc_c)
            x = x / (E * sc_b)
            y = y / (D * sc_c)
            s = s * E / (sc_c * stgs.scale)

        return ConicSolution(
            x=x, y=y, s=s,
            status=int(status), status_name=Status.name(status),
            pobj=res_np["pobj"], dobj=res_np["dobj"],
            res_pri=res_np["res_pri"], res_dual=res_np["res_dual"],
            rel_gap=res_np["rel_gap"],
            res_infeas=res_np["res_infeas"], res_unbdd=res_np["res_unbdd"],
            ipm_iters=ipm_iter + 1, admm_iters=int(state.k),
            setup_time=self.setup_time,
            solve_time=time.perf_counter() - t0,
            avg_cg_iters=float(state.cg_iters) / max(1, int(state.k)),
        )


def solve_qcp(A, b, c, cones: ConeSpec, Q=None,
              settings: Optional[Settings] = None, tol_ladder=None,
              solver_factory=None, **overrides) -> ConicSolution:
    """One-call conic solve (`abip()`, `source/abip.c:1335-1371`)."""
    settings = settings or conic_defaults()
    if overrides:
        settings = dataclasses.replace(settings, **overrides)
    w = ConicWorkspace(A, b, c, cones, Q=Q, settings=settings,
                       tol_ladder=tol_ladder, solver_factory=solver_factory)
    return w.solve()
