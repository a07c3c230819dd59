"""Fully-on-device conic solver for batched suite runs.

The conic analogue of `batched.py`: outer barrier loop AND inner DR loop
as nested `lax.while_loop`s composed from `abip.conic_ops`, vmapped
over same-shape instances.  This is the device replacement for the
reference's LASSO/SVM sweep protocol (`scripts/bench-qcp/test_lasso.m`:
a grid of instances run one process at a time) -- the whole sweep becomes
one XLA program.

The cone structure (`ConeSpec`) is static and shared across the batch;
instance data (A, b, c, optional diagonal Q) is batched.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import conic_ops
from ..cones import ConeLayout, ConeSpec
from ..linsys.schur import DenseSchurSolver


class ConicDeviceResult(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray
    s: jnp.ndarray
    status: jnp.ndarray
    ipm_iters: jnp.ndarray
    admm_iters: jnp.ndarray
    res_pri: jnp.ndarray
    res_dual: jnp.ndarray
    rel_gap: jnp.ndarray
    pobj: jnp.ndarray
    dobj: jnp.ndarray
    # raw internal state (scaled space) for phase hand-off: the
    # two-phase conic sprint driver resumes unfinished lanes from these
    # (mirrors batched.DeviceSolveResult)
    u_raw: jnp.ndarray = None
    v_raw: jnp.ndarray = None
    mu: jnp.ndarray = None
    tol_inner: jnp.ndarray = None


f32 = jnp.float32
f64 = jnp.float64


class _AnchorQ(NamedTuple):
    """Per-stage anchor for mixed-precision conic operator application
    (the conic analogue of `batched._Anchor`; see `batched.py` docstring
    for the anchored-delta scheme)."""

    x0: jnp.ndarray     # matvec operand anchor (x block of u)
    y0: jnp.ndarray     # rmatvec operand anchor
    Ax0: jnp.ndarray
    ATy0: jnp.ndarray
    wy0: jnp.ndarray    # projection rhs anchors
    wx0: jnp.ndarray
    rhs0: jnp.ndarray
    zx0: jnp.ndarray    # Schur solution anchor
    Azx0: jnp.ndarray
    Szx0: jnp.ndarray   # S64 @ zx0 (for anchored iterative refinement)


class PreparedConic(NamedTuple):
    """Cached per-instance setup: equilibrated data + Schur factors +
    the tau-quadratic precompute, all as vmappable ARRAYS so repeated
    calls (resume rounds, compaction buckets, warm re-solves) skip the
    setup chain entirely.  Build with `prepare_conic_batch`; pass via
    `solve_qcp_batch(..., prepared=...)`.  The dss pytree's static aux
    (mode, form) fixes the solver/form for every consuming call."""

    A: jnp.ndarray          # scaled
    b: jnp.ndarray
    c: jnp.ndarray
    Q_diag: jnp.ndarray     # scaled (None when no quadratic term)
    D: jnp.ndarray
    E: jnp.ndarray
    sc_b: jnp.ndarray
    sc_c: jnp.ndarray
    nm_inf_b0: jnp.ndarray  # inf-norms of the ORIGINAL data
    nm_inf_c0: jnp.ndarray
    dss: DenseSchurSolver   # registered pytree (factors as leaves)
    r_vec: jnp.ndarray      # K^-1(-b; c) (`pre_calculate`)
    a_coef: jnp.ndarray


def _device_solve_qcp(A, b, c, Q_diag, layout: ConeLayout, *, eps, max_ipm,
                      max_admm, alpha, rho_y, rho_x, rho_tau, psi,
                      inner_check_period, precision="f64", ir_steps=1,
                      inner_crit_period=1, solver="cholesky",
                      normalize=False, anchor_period=100, form="auto",
                      cadence="cond", probe_period=8, scaling=None,
                      engine="steps", sprint_mu_switch=1e-3, mu_stop=0.0,
                      init_state=None, k_cap=None, prepared=None):
    """One conic instance entirely on device (no equilibration: callers
    pre-scale, as the reference app configs do).  Dense Schur backend.

    precision="mixed": per-stage anchored f32 matvecs/solves with f64
    state, as in `batched.device_solve_lp`.

    scaling: optional (D, E, sc_b, sc_c, nm_inf_b0, nm_inf_c0) tuple
    when the CALLER already equilibrated (A, b, c, Q): residuals and
    the returned solution are then un-scaled exactly as normalize=True
    would, but the scaling arrives as vmappable DATA (the
    heterogeneous-cone batch equilibrates per lane on host at each
    lane's natural shape, then pads -- padded slots carry D=E=1)."""
    # cadence knobs must be >= 1: anchor_period < 1 in mixed mode makes the
    # jitted outer loop non-terminating (stage_cap=0 => cap_exit re-anchors
    # forever without advancing k), and period 0 is a traced modulo-by-zero
    if anchor_period < 1 or inner_crit_period < 1 or inner_check_period < 1 \
            or probe_period < 1:
        raise ValueError(
            "anchor_period, inner_crit_period, inner_check_period, and "
            f"probe_period must be >= 1; got {anchor_period}, "
            f"{inner_crit_period}, {inner_check_period}, {probe_period}")
    if cadence not in ("cond", "chunk"):
        raise ValueError(f"cadence must be 'cond' or 'chunk'; got {cadence!r}")
    if k_cap is None:
        kcap = jnp.asarray(max_admm, jnp.int32)
    else:
        kcap = jnp.minimum(jnp.asarray(k_cap, jnp.int32), max_admm)
    if engine not in ("steps", "sprint", "ladder", "delta"):
        raise ValueError(f"engine must be 'steps', 'sprint', 'ladder', "
                         f"or 'delta'; got {engine!r}")
    sprint = engine == "sprint"
    ladder_eng = engine == "ladder"
    delta_eng = engine == "delta"
    if delta_eng and cadence != "chunk":
        raise ValueError("engine='delta' requires cadence='chunk'")
    if delta_eng and init_state is None:
        # the conic delta chunk does NOT implement the first-iteration
        # tau_t := 1 special case (`source/abip.c:186-254`; see
        # conic_delta_anchor's NOTE) -- it is an ENDGAME entered at
        # k > 0.  A cold start would silently diverge from the
        # reference trajectory on iteration 0.
        raise ValueError(
            "engine='delta' is an endgame: pass init_state from a prior "
            "steps/sprint phase (cold start lacks the k=0 tau_t=1 case)")
    if sprint or ladder_eng:
        # the fused f32 loops replace the whole inner chunk (sprint) or
        # the whole barrier ladder (ladder); both are pure f32, so they
        # only run phase-1 style -- above the mu switch, with the
        # anchored engines taking the accuracy endgame (the two-phase
        # driver in solve_qcp_batch wires this up)
        if not (mu_stop and mu_stop >= sprint_mu_switch):
            raise ValueError(f"engine={engine!r} runs phase-1 style: pass "
                             "mu_stop >= sprint_mu_switch")
        if cadence != "chunk":
            raise ValueError(f"engine={engine!r} requires cadence='chunk'")
        if not isinstance(layout, ConeLayout):
            raise ValueError(f"engine={engine!r} requires a static "
                             "ConeLayout (heterogeneous padded layouts "
                             "use steps)")
    chunked = cadence == "chunk"
    if prepared is not None:
        if normalize or scaling is not None:
            raise ValueError("prepared already carries the scaling; do "
                             "not also pass normalize=True or scaling=")
        A, b, c, Q_diag = prepared.A, prepared.b, prepared.c, prepared.Q_diag
        scaling = (prepared.D, prepared.E, prepared.sc_b, prepared.sc_c,
                   prepared.nm_inf_b0, prepared.nm_inf_c0)
    dtype = A.dtype
    m, n = A.shape
    l = m + n + 1
    mixed = precision == "mixed"
    if prepared is not None:
        want_mode = "newton" if mixed else "chol"
        if prepared.dss.mode != want_mode:
            raise ValueError(
                f"prepared factors were built mode={prepared.dss.mode!r} "
                f"but precision={precision!r} needs {want_mode!r}: call "
                "prepare_conic_batch with the same precision")

    # inf-norms of ORIGINAL data (`init_work`, `source/abip.c:873-874`)
    nm_inf_b0 = jnp.max(jnp.abs(b)) if m else jnp.zeros((), dtype)
    nm_inf_c0 = jnp.max(jnp.abs(c))
    if scaling is not None:
        if normalize:
            raise ValueError("pass either normalize=True or scaling, not both")
        D_s, E_s, sc_b, sc_c, nm_inf_b0, nm_inf_c0 = scaling
    elif normalize:
        # same cone-tied equilibration as the host driver (the batched
        # path previously required callers to pre-scale; unscaled data
        # can stall the fixed-rho DR iteration)
        from ..qcp import conic_defaults
        from ..scaling import equilibrate_conic

        # Q (diagonal or full) rides the equilibration so E sees its
        # magnitudes (`qcp_config.c:239-248`; parity-relevant)
        A, Q_diag, b, c, scal = equilibrate_conic(
            A, Q_diag, b, c, layout, conic_defaults())
        D_s, E_s = scal.D, scal.E
        sc_b, sc_c = scal.sc_b, scal.sc_c
    else:
        D_s = jnp.ones((m,), dtype)
        E_s = jnp.ones((n,), dtype)
        sc_b = jnp.ones((), dtype)
        sc_c = jnp.ones((), dtype)

    rho = jnp.concatenate([
        jnp.full((m,), rho_y, dtype),
        jnp.full((n,), rho_x, dtype),
        jnp.full((1,), rho_tau, dtype),
    ])
    rho_tail = rho[m:]
    ry_inv = 1.0 / rho[:m]

    full_Q = Q_diag is not None and Q_diag.ndim == 2

    def Q_times(x):
        if Q_diag is None:
            return jnp.zeros_like(x)
        return Q_diag @ x if full_Q else Q_diag * x

    A32 = A.astype(f32)
    ry_inv32 = ry_inv.astype(f32)
    # Dual (Woodbury) form when m < n: H = rho_x + Q_diag is diagonal
    # here by construction, so factor the m x m  G = rho_y I + A H^-1 A'
    # instead of the n x n Schur complement S (same per-shape dispatch as
    # the host `DenseSchurSolver`; reference analogue lasso_config.c:507-565).
    # Solutions are identical up to roundoff; setup drops from O(n^3/3)
    # to O(m^2 n + m^3/3) and the f64 stage-anchor solves shrink 9x at
    # m = n/3.
    if prepared is not None:
        # the prepared factors fix the form (static pytree aux)
        woodbury = prepared.dss.form == "woodbury"
    elif form == "auto":
        # Woodbury's extra per-apply products are cheaper than the n^2
        # primal apply only when m is well under n; on equal footing the
        # primal form has fewer ops in the loop body (matters on CPU,
        # where per-op dispatch overhead dominates tiny matmuls).
        # A full (2-D) Q makes H non-diagonal: primal form only.
        woodbury = 2 * m <= n and not full_Q
    else:
        woodbury = form == "woodbury"
    if woodbury and m >= n:
        raise ValueError("form='woodbury' requires m < n")
    if woodbury and full_Q:
        raise ValueError("form='woodbury' requires a diagonal (or no) Q")
    # The f64 factor + solve algebra lives ONCE in DenseSchurSolver
    # (registered pytree, safe to close over in the jitted program); the
    # driver only adds the f32/anchored variants around its factors.
    # mixed mode factors in f32 + Newton-refined explicit inverse
    # (mode="newton", see linsys.schur._newton_inverse): no f64
    # triangular solves in the explicit-inverse build
    dss = prepared.dss if prepared is not None else DenseSchurSolver(
        A, Q_diag, rho[:m], rho[m : m + n],
        mode="newton" if mixed else "chol",
        form="woodbury" if woodbury else "primal")

    def solve_fn(w_y, w_x, k, warm):
        return dss.solve(w_y, w_x)

    if woodbury:
        H_inv = dss.H_inv
        H = 1.0 / H_inv
        H_inv32 = H_inv.astype(f32)
        if mixed:
            Ginv32 = dss.Ginv64.astype(f32)

            def gsolve32(r32):
                return Ginv32 @ r32
        elif solver == "inverse":
            Ginv32 = jax.scipy.linalg.cho_solve(
                (dss.cholG, True), jnp.eye(m, dtype=dtype)).astype(f32)

            def gsolve32(r32):
                return Ginv32 @ r32
        else:
            cholG32 = dss.cholG.astype(f32)

            def gsolve32(r32):
                return jax.scipy.linalg.cho_solve((cholG32, True), r32)

        def solve32(r32):
            """f32 S^-1 apply via the dual factor (delta systems)."""
            t = H_inv32 * r32
            u = gsolve32(A32 @ t)
            return t - H_inv32 * (A32.T @ u)

        def S_times32(dz32):
            """f32 S @ dz matrix-free (for anchored IR): S = H + A'Ry^-1 A."""
            return H * (dz32.astype(f64)) + (
                A32.T @ (ry_inv32 * (A32 @ dz32))).astype(f64)
    else:
        S = (A * ry_inv[:, None]).T @ A + rho_x * jnp.eye(n, dtype=dtype)
        if full_Q:
            S = S + Q_diag
        elif Q_diag is not None:
            S = S + jnp.diag(Q_diag)
        S32 = S.astype(f32)
        if mixed:
            Sinv32 = dss.Sinv64.astype(f32)

            def solve32(r32):
                return Sinv32 @ r32
        elif solver == "inverse":
            # explicit inverse: one f32 matmul per apply instead of two
            # triangular solves (same trick as the LP driver,
            # accuracy restored by the anchored IR against S)
            Sinv32 = jax.scipy.linalg.cho_solve(
                (dss.chol, True), jnp.eye(n, dtype=dtype)).astype(f32)

            def solve32(r32):
                return Sinv32 @ r32
        else:
            chol32 = dss.chol.astype(f32)

            def solve32(r32):
                return jax.scipy.linalg.cho_solve((chol32, True), r32)

        def S_times32(dz32):
            return (S32 @ dz32).astype(f64)

    def S_times64(z):
        """f64 S @ z matrix-free (anchor setup only, once per stage)."""
        return rho_x * z + Q_times(z) + A.T @ (ry_inv * (A @ z))

    def make_anchor(u, v) -> _AnchorQ:
        """One f64-quality pass per barrier stage."""
        x0 = u[m : m + n]
        y0 = u[:m]
        w = rho[: m + n] * (u[: m + n] + v[: m + n])
        wy0, wx0 = w[:m], w[m:]
        _, zx0, _ = solve_fn(wy0, wx0, -1, None)
        rhs0 = wx0 + A.T @ (ry_inv * wy0)
        return _AnchorQ(x0=x0, y0=y0, Ax0=A @ x0, ATy0=A.T @ y0,
                        wy0=wy0, wx0=wx0, rhs0=rhs0, zx0=zx0,
                        Azx0=A @ zx0, Szx0=S_times64(zx0))

    def make_ops(anc: _AnchorQ):
        if not mixed:
            return (lambda x: A @ x), (lambda y: A.T @ y), solve_fn

        def amv(x):
            return anc.Ax0 + (A32 @ (x - anc.x0).astype(f32)).astype(f64)

        def armv(y):
            return anc.ATy0 + (A32.T @ (y - anc.y0).astype(f32)).astype(f64)

        def anchored_solve(w_y, w_x, k, warm):
            dwy32 = (w_y - anc.wy0).astype(f32)
            drhs = (w_x - anc.wx0) + (
                A32.T @ (ry_inv32 * dwy32)).astype(f64)
            dzx = solve32(drhs.astype(f32)).astype(f64)
            z_x = anc.zx0 + dzx
            rhs = anc.rhs0 + drhs
            for _ in range(ir_steps):
                # anchored IR: S z = Szx0 + S32(z - zx0), all f32 matmuls
                # (S32 applied matrix-free in the Woodbury form)
                Sz = anc.Szx0 + S_times32((z_x - anc.zx0).astype(f32))
                resid = rhs - Sz
                z_x = z_x + solve32(resid.astype(f32)).astype(f64)
            Az = anc.Azx0 + (A32 @ (z_x - anc.zx0).astype(f32)).astype(f64)
            z_y = ry_inv * (w_y - Az)
            return z_y, z_x, jnp.zeros((), jnp.int32)

        return amv, armv, anchored_solve

    if prepared is not None:
        r_vec = prepared.r_vec
        a_coef = prepared.a_coef
    else:
        r_y, r_x, _ = solve_fn(-b, c, -1, None)
        r_vec = jnp.concatenate([r_y, r_x])
        a_coef = rho_tau + jnp.dot(rho[: m + n] * r_vec, r_vec)

    if sprint or ladder_eng or delta_eng:
        from ..ops.conic_sprint import (cone_kernel_data, fused_dr_ladder,
                                        fused_dr_sprint_stop)

        if full_Q:
            raise ValueError(
                f"engine={engine!r} supports diagonal (or no) Q")
        cdk = cone_kernel_data(layout)
        if woodbury:
            Minv32s = (dss.Ginv64.astype(f32) if mixed
                       else jax.scipy.linalg.cho_solve(
                           (dss.cholG, True),
                           jnp.eye(m, dtype=dtype)).astype(f32))
            Hinv32s = dss.H_inv.astype(f32)
        else:
            Minv32s = (dss.Sinv64.astype(f32) if mixed
                       else jax.scipy.linalg.cho_solve(
                           (dss.chol, True),
                           jnp.eye(n, dtype=dtype)).astype(f32))
            Hinv32s = jnp.zeros((n,), f32)
        rvec32 = r_vec.astype(f32)
        b32s = b.astype(f32)
        c32s = c.astype(f32)
        Qd32s = (Q_diag.astype(f32) if Q_diag is not None
                 else jnp.zeros((n,), f32))
        D32s = D_s.astype(f32)
        E32s = E_s.astype(f32)

    def residuals(u, v_origin, prev, mv, rmv):
        return conic_ops.conic_residuals(
            u, v_origin, prev, mv, rmv, Q_times, b, c,
            D_s, E_s, sc_b, sc_c, 1.0,
            nm_inf_b0, nm_inf_c0, eps, eps, eps, m, n,
        )

    def converged(r, total_pos):
        return conic_ops.conic_converged_code(r, eps, eps, eps, eps, eps,
                                              0.0, total_pos)

    class IC(NamedTuple):
        u: jnp.ndarray
        v: jnp.ndarray
        v_origin: jnp.ndarray
        j: jnp.ndarray
        k: jnp.ndarray
        err_inner: jnp.ndarray
        status: jnp.ndarray
        res: conic_ops.ConicResiduals

    class OC(NamedTuple):
        inner: IC
        mu: jnp.ndarray
        tol_inner: jnp.ndarray
        i: jnp.ndarray
        # consecutive stages that stalled AT the mu floor (f32 criterion
        # noise floor; see the stage_budget note) -- two in a row end
        # the solve with the stagnation code
        stall: jnp.ndarray = jnp.zeros((), jnp.int32)

    def mv64(x):
        return A @ x

    def rmv64(y):
        return A.T @ y

    def inner_body(s: IC, mu, ipm_i, mv, rmv, stage_solve):
        u_t, _ = conic_ops.projection(s.u, s.v, stage_solve, rho, r_vec,
                                      a_coef, Q_times, m, n, s.k)
        u, v = conic_ops.barrier_and_dual(s.u, s.v, u_t, mu, rho_tail,
                                          layout, alpha, m, n)
        v_origin = rho * v
        k = s.k + 1
        # the inner HSD-mismatch criterion costs 2 matvecs; the reference
        # evaluates it every iteration (source/abip.c:1150-1156), and
        # inner_crit_period=1 reproduces that.  P>1 checks every P-th
        # iteration (stage overrun <= P-1 iterations) to thin the body.
        if inner_crit_period == 1:
            err_inner = conic_ops.inner_conv_check(u, v_origin, mv, rmv,
                                                   Q_times, b, c, m, n)
        else:
            err_inner = jax.lax.cond(
                (s.j + 1) % inner_crit_period == 0,
                lambda _: conic_ops.inner_conv_check(u, v_origin, mv, rmv,
                                                     Q_times, b, c, m, n),
                lambda _: s.err_inner, None)
        # Residual checks use TRUE f64 products (mv64/rmv64), never the
        # stage-anchored f32 deltas: an f32 matmul's accumulation error
        # (~sqrt(n)*eps32) floors the MEASURED residual around 1e-6 at
        # dim ~1000 even when the iterate is converged to 1e-13
        # (measured: reported pres 1.4e-6 vs true 6e-13 -> permanent
        # stall at eps=1e-6).  The cadence amortizes the f64 cost; in
        # mixed mode the endgame cadence (error_ratio <= 8 means the
        # crossing is near) is thinned to every inner_crit_period-th
        # iteration, bounding overrun at P-1 iterations, so per-iteration
        # f64 checks do not dominate the endgame.
        endgame_p = inner_crit_period if mixed else 1
        do_check = ((s.j + 1) % inner_check_period == 0) | (
            (s.res.error_ratio <= 8.0) & ((s.j + 1) % endgame_p == 0)
        )

        def check(_):
            r = residuals(u, v_origin, s.res, mv64, rmv64)
            return r, converged(r, (ipm_i > 0) & (k > 0))

        r, st = jax.lax.cond(do_check, check,
                             lambda _: (s.res, jnp.zeros((), jnp.int32)),
                             None)
        return IC(u=u, v=v, v_origin=v_origin, j=s.j + 1, k=k,
                  err_inner=err_inner, status=st, res=r)

    def inner_body_chunk(s: IC, mu, ipm_i, mv, rmv, stage_solve,
                         tol_inner, stage_cap):
        """Structural cadence for vmapped programs WITH an in-chunk
        stop: micro-trips of `probe_period` uniform lean iterations
        (`lax.fori_loop`), each followed by the CHEAP inner criterion
        (`inner_conv_check` through the stage-anchored matvecs -- 2 per
        trip), exiting as soon as it fires; then the EXPENSIVE f64
        residual check exactly once per chunk exit, at most
        `inner_crit_period` iterations apart.  The stage overruns its
        true stopping point (`source/abip.c:1150-1156` checks every
        iteration) by at most probe_period-1 iterations instead of
        inner_crit_period-1.  Under `vmap`, the cond-gated cadence above
        lowers to compute-both-branches + select, silently running the
        f64 residual check on EVERY iteration of EVERY lane (see
        `batched.device_solve_lp`'s cadence note)."""
        probe = min(probe_period, inner_crit_period)

        def lean(_, t):
            u, v = t
            u_t, _ = conic_ops.projection(u, v, stage_solve, rho, r_vec,
                                          a_coef, Q_times, m, n, s.k)
            return conic_ops.barrier_and_dual(u, v, u_t, mu, rho_tail,
                                              layout, alpha, m, n)

        def micro_cond(t):
            _u, _v, dk, err = t
            return ((err >= tol_inner) & (dk < inner_crit_period)
                    & (s.j + dk < stage_cap) & (s.k + dk < kcap))

        def micro_body(t):
            u, v, dk, _err = t
            u, v = jax.lax.fori_loop(0, probe, lean, (u, v))
            dk = dk + probe
            err = conic_ops.inner_conv_check(u, rho * v, mv, rmv,
                                             Q_times, b, c, m, n)
            return (u, v, dk, err)

        u, v, dk, err_inner = jax.lax.while_loop(
            micro_cond, micro_body,
            (s.u, s.v, jnp.zeros((), jnp.int32), s.err_inner))
        v_origin = rho * v
        k = s.k + dk
        r = residuals(u, v_origin, s.res, mv64, rmv64)
        st = converged(r, (ipm_i > 0) & (k > 0))
        # f64-AUTHORITATIVE inner criterion at the chunk boundary: the
        # anchored-f32 probe above floors at ~sqrt(q)*eps32 absolute
        # (at q=21002 stages could never meet tol = gamma*mu below the
        # floor and pres pinned at 2.9e-3), so stage advancement is gated
        # on a true-f64 evaluation -- 2 f64 matvecs amortized over up to
        # inner_crit_period iterations.
        err64 = conic_ops.inner_conv_check(u, v_origin, mv64, rmv64,
                                           Q_times, b, c, m, n)
        return IC(u=u, v=v, v_origin=v_origin, j=s.j + dk,
                  k=k, err_inner=err64, status=st, res=r)

    def sprint_chunk(s: IC, o: "OC"):
        """One fused f32 chunk: up to inner_crit_period DR iterations
        with the in-loop inner-criterion stop, then ONE f64
        residual/status check -- the conic analogue of the LP driver's
        sprint_chunk (`batched.py`)."""
        probe = min(probe_period, inner_crit_period)
        u2, v2, t_done, err = fused_dr_sprint_stop(
            A32, Minv32s, Hinv32s, rvec32, b32s, c32s, Qd32s, cdk,
            rho_y, rho_x, rho_tau, a_coef, o.mu, alpha, o.tol_inner,
            s.u.astype(f32), s.v.astype(f32), s.k.astype(f32),
            T=inner_crit_period, probe=probe, woodbury=woodbury)
        u = u2.astype(dtype)
        v = v2.astype(dtype)
        v_origin = rho * v
        k = s.k + t_done
        r = residuals(u, v_origin, s.res, mv64, rmv64)
        st = converged(r, (o.i > 0) & (k > 0))
        return IC(u=u, v=v, v_origin=v_origin, j=s.j + t_done, k=k,
                  err_inner=err.astype(dtype), status=st, res=r)

    def delta_chunk(s: IC, o: "OC"):
        """One anchored-delta chunk (`ops/conic_delta.py`): up to
        inner_crit_period f32 delta iterations from a fresh f64 anchor,
        then ONE f64 residual/status check -- the conic endgame at LP
        delta-engine economy."""
        from ..ops.conic_delta import run_conic_delta_chunk

        probe = min(probe_period, inner_crit_period)
        res_d = run_conic_delta_chunk(
            A, solve_fn, Q_diag if Q_diag is not None else None,
            r_vec[:m], r_vec[m:], b, c, a_coef, rho_y, rho_x, rho_tau,
            o.mu, alpha, o.tol_inner, s.u, s.v, s.err_inner,
            layout, cdk, A32, Minv32s, Hinv32s, woodbury,
            T=inner_crit_period, probe=probe)
        u = res_d.u
        v = res_d.v
        v_origin = rho * v
        k = s.k + res_d.t_done
        r = residuals(u, v_origin, s.res, mv64, rmv64)
        st = converged(r, (o.i > 0) & (k > 0))
        # f64-authoritative criterion at the chunk boundary (see
        # inner_body_chunk: the chunk's f32 delta-frame value floors
        # at ~sqrt(q)*eps32 and pinned wide embeddings)
        err64 = conic_ops.inner_conv_check(u, v_origin, mv64, rmv64,
                                           Q_times, b, c, m, n)
        return IC(u=u, v=v, v_origin=v_origin, j=s.j + res_d.t_done,
                  k=k, err_inner=err64, status=st, res=r)

    def outer_body(o: OC):
        s = o.inner._replace(
            j=jnp.zeros((), jnp.int32),
            err_inner=jnp.full((), jnp.inf, dtype),
            status=jnp.zeros((), jnp.int32),
        )
        if ladder_eng:
            # the WHOLE barrier ladder runs inside one f32 loop
            # (adjust_barrier on the f32 error-ratio); one f64
            # residual/status pass per loop.  A T-cap exit returns
            # with mu still >= mu_stop and outer_cond re-enters.
            probe = min(probe_period, inner_crit_period)
            u2, v2, t_done, err, mu2, tol2, stages = fused_dr_ladder(
                A32, Minv32s, Hinv32s, rvec32, b32s, c32s, Qd32s,
                D32s, E32s, cdk, rho_y, rho_x, rho_tau, a_coef,
                o.mu, o.tol_inner, jnp.asarray(mu_stop, f32),
                jnp.asarray(eps, f32), sc_b, sc_c, nm_inf_b0,
                nm_inf_c0, alpha, s.u.astype(f32), s.v.astype(f32),
                s.k.astype(f32), T=max(2048, inner_crit_period),
                probe=probe, psi=float(psi), woodbury=woodbury)
            u = u2.astype(dtype)
            v = v2.astype(dtype)
            v_origin = rho * v
            k = s.k + t_done
            r = residuals(u, v_origin, s.res, mv64, rmv64)
            st = converged(r, (o.i > 0) & (k > 0))
            s = s._replace(u=u, v=v, v_origin=v_origin, j=s.j + t_done,
                           k=k, err_inner=err.astype(dtype), status=st,
                           res=r)
            return OC(inner=s, mu=mu2.astype(dtype),
                      tol_inner=tol2.astype(dtype), i=o.i + stages)
        if sprint or delta_eng:
            # no per-stage anchors: the chunk re-derives its f32 state
            # from the carried f64 iterate at every chunk entry.
            # stage_budget bounds one stage: the f32 engines' inner
            # criterion has a noise floor ~sqrt(q)*eps32, and once the
            # gamma*mu^psi tolerance drops below it a stage can NEVER
            # meet its criterion (measured: the q=21002 LASSO embedding
            # pinned mu at stage 7 for 1e6 iterations).  A stage that
            # burns the budget advances the barrier anyway -- a LAST-
            # RESORT guard, floored at 16384 iterations so legitimate
            # hard stages (r04 straggler data: one phase-2 stage ran
            # 11,256 iterations) are untouched, and so a small
            # inner_crit_period cannot shrink the budget into the
            # normal operating range (8*T with T=1 mis-stalled every
            # fuzz class at ~100 iterations).  The f64-authoritative
            # chunk-boundary criterion handles the floor in the common
            # case; this bounds the pathological remainder.
            stage_budget = max(16384, 8 * inner_crit_period)

            def icond_s(s: IC):
                return ((s.err_inner >= o.tol_inner) & (s.status == 0)
                        & (s.k < kcap) & (s.j < stage_budget))

            chunk_fn = delta_chunk if delta_eng else sprint_chunk
            s = jax.lax.while_loop(icond_s, lambda ss: chunk_fn(ss, o),
                                   s)
            r = residuals(s.u, s.v_origin, s.res, mv64, rmv64)
            st = jnp.where(s.status != 0, s.status,
                           converged(r, (o.i > 0) & (s.k > 0)))
            s = s._replace(res=r, status=st)
            mu, tol = conic_ops.adjust_barrier_device(o.mu, r.error_ratio,
                                                      eps, psi)
            done = st != 0
            stalled = s.j >= stage_budget
            cap_exit = (s.err_inner >= o.tol_inner) & ~stalled
            # mu floor for stall-advances: unbounded advances drove mu
            # to 0.17^200 ~ 1e-154, whose f32 barrier weight underflows
            # to zero and NaNs the prox (measured on the q=21002 LASSO
            # cell).  At the floor, a stalled stage keeps mu and counts
            # toward the stagnation exit (status 2, `has_converged`'s
            # res_dif role) instead.
            at_floor = stalled & (o.mu <= eps * 1e-3)
            mu = jnp.where(done | cap_exit | at_floor, o.mu, mu)
            tol = jnp.where(cap_exit | at_floor, o.tol_inner, tol)
            di = jnp.where(cap_exit, 0, 1).astype(o.i.dtype)
            stall_new = jnp.where(at_floor, o.stall + 1,
                                  jnp.zeros((), jnp.int32))
            st = jnp.where((st == 0) & (stall_new >= 2), 2, st)
            s = s._replace(status=st)
            return OC(inner=s, mu=mu, tol_inner=tol, i=o.i + di,
                      stall=stall_new)
        anc = make_anchor(s.u, s.v)
        mv, rmv, stage_solve = make_ops(anc)

        # mixed mode: cap the per-anchor trip count -- the anchored f32
        # delta products lose accuracy as iterates drift from the stage
        # anchor, and a stage can run tens of thousands of iterations
        # (measured NaN blow-up on an equilibrated SOC instance whose
        # stage ran >10k iters).  On cap-exit the outer body re-anchors
        # WITHOUT advancing the barrier.  f64 mode has no anchors: the
        # cap stays at the stage budget so trajectories are untouched.
        stage_cap = anchor_period if mixed else max_admm

        def icond(s: IC):
            return (
                (s.j < stage_cap)
                & (s.err_inner >= o.tol_inner)
                & (s.status == 0)
                & (s.k < kcap)
            )

        if chunked:
            ibody = lambda ss: inner_body_chunk(  # noqa: E731
                ss, o.mu, o.i, mv, rmv, stage_solve, o.tol_inner, stage_cap)
        else:
            ibody = lambda ss: inner_body(  # noqa: E731
                ss, o.mu, o.i, mv, rmv, stage_solve)
        s = jax.lax.while_loop(icond, ibody, s)
        r = residuals(s.u, s.v_origin, s.res, mv64, rmv64)
        st = jnp.where(s.status != 0, s.status,
                       converged(r, (o.i > 0) & (s.k > 0)))
        s = s._replace(res=r, status=st)
        mu, tol = conic_ops.adjust_barrier_device(o.mu, r.error_ratio, eps, psi)
        done = st != 0
        # cap-exit (inner criterion not yet met): re-anchor only, keep
        # the barrier where it is
        cap_exit = s.err_inner >= o.tol_inner
        mu = jnp.where(done | cap_exit, o.mu, mu)
        tol = jnp.where(cap_exit, o.tol_inner, tol)
        # cap-exits re-anchor without consuming a barrier stage; total
        # work stays bounded by the k < max_admm guard (max_admm is the
        # TOTAL ADMM budget here -- see the solve_qcp_batch docstring)
        di = jnp.where(cap_exit, 0, 1).astype(o.i.dtype)
        return OC(inner=s, mu=mu, tol_inner=tol, i=o.i + di)

    def outer_cond(o: OC):
        alive = (o.inner.status == 0) & (o.i < max_ipm) & (
            o.inner.k < kcap
        )
        if mu_stop > 0.0:
            # phase-boundary exit (see batched.device_solve_lp): stop
            # with status 0 once the barrier passes mu_stop so a second
            # program can continue with a different engine
            alive = alive & (o.mu >= mu_stop)
        return alive

    if init_state is None:
        x0 = layout.interior_point(dtype)
        u0 = jnp.concatenate([jnp.zeros((m,), dtype), x0,
                              jnp.ones((1,), dtype)])
        init = OC(
            inner=IC(u=u0, v=u0, v_origin=rho * u0,
                     j=jnp.zeros((), jnp.int32), k=jnp.zeros((), jnp.int32),
                     err_inner=jnp.full((), jnp.inf, dtype),
                     status=jnp.zeros((), jnp.int32),
                     res=conic_ops.ConicResiduals.init(dtype)),
            mu=jnp.ones((), dtype),
            tol_inner=jnp.asarray(4.0, dtype),
            i=jnp.zeros((), jnp.int32),
        )
    else:
        # phase hand-off resume: (u, v, mu, tol_inner, k, i, status);
        # the conic driver carries no stage-average state, so the
        # 7-tuple is complete
        u_i, v_i, mu_i, tol_i, k_i, i_i, st_i = init_state
        u_i = u_i.astype(dtype)
        v_i = v_i.astype(dtype)
        init = OC(
            inner=IC(u=u_i, v=v_i, v_origin=rho * v_i,
                     j=jnp.zeros((), jnp.int32),
                     k=k_i.astype(jnp.int32),
                     err_inner=jnp.full((), jnp.inf, dtype),
                     status=st_i.astype(jnp.int32),
                     res=conic_ops.ConicResiduals.init(dtype)),
            mu=mu_i.astype(dtype),
            tol_inner=tol_i.astype(dtype),
            i=i_i.astype(jnp.int32),
        )
    fin = jax.lax.while_loop(outer_cond, outer_body, init)

    s = fin.inner
    r = s.res
    tau = jnp.maximum(r.tau, conic_ops.EPS_TOL)
    return ConicDeviceResult(
        x=s.u[m : m + n] / tau / (E_s * sc_b),
        y=s.u[:m] / tau / (D_s * sc_c),
        s=s.v[m : m + n] / tau * E_s / sc_c,
        status=s.status, ipm_iters=fin.i, admm_iters=s.k,
        res_pri=r.res_pri, res_dual=r.res_dual, rel_gap=r.rel_gap,
        pobj=r.pobj, dobj=r.dobj,
        u_raw=s.u, v_raw=s.v, mu=fin.mu, tol_inner=fin.tol_inner,
    )


def solve_qcp_batch(As, bs, cs, Q_diags=None, *, engine="steps", **kw
                    ) -> ConicDeviceResult:
    """Solve a stacked batch of same-shape conic programs on device.

    Thin dispatcher: engine="steps" (default) runs the single-program
    nested-while driver; engine="sprint2" runs the TWO-phase conic
    sprint -- phase 1 drives every lane with the fused f32 DR loop
    (`ops/conic_sprint.py`) until its barrier passes `sprint_mu_switch`,
    phase 2 finishes unfinished lanes with the anchored steps engine
    (same split as the LP driver; each program stays branch-free under
    vmap).  See `_solve_qcp_batch_jit` for the full option list.
    """
    if engine == "sprint2":
        return _solve_qcp_batch_twophase(As, bs, cs, Q_diags, **kw)
    return _solve_qcp_batch_jit(As, bs, cs, Q_diags, engine=engine, **kw)


def _solve_qcp_batch_twophase(As, bs, cs, Q_diags=None, *,
                              sprint_mu_switch=1e-3, **kw
                              ) -> ConicDeviceResult:
    """Two-phase conic sprint.  sprint_mu_switch=1e-3: below that the
    shrinking inner tolerance (gamma * mu^psi) approaches the pure-f32
    iterate's criterion noise floor and phase-1 stages run away
    (measured: switch 1e-4 inflated a 456-iteration solve to 48,920 and
    NaN'd another lane; 1e-3/1e-2/3e-2 all track the f64 stage
    structure within ~25%)."""
    kw.pop("mu_stop", None)
    kw.pop("init_state", None)
    kw.setdefault("cadence", "chunk")
    kw.setdefault("solver", "inverse")
    # endgame="delta" (default): finish unfinished lanes with the
    # anchored-delta conic engine (`ops/conic_delta.py`) --
    # trajectory-identical counts on the CPU parity batch.
    # endgame="steps" restores the anchored-f64 path.
    endgame = kw.pop("endgame", "delta")
    if endgame not in ("steps", "delta"):
        raise ValueError(f"endgame must be 'steps' or 'delta'; "
                         f"got {endgame!r}")
    # phase-2 straggler COMPACTION (LP twophase analogue): the conic
    # endgame holds ~97% of the iterations (the mu ladder passes the
    # 1e-3 switch after ~32), and one straggler lane taxes the whole
    # vmapped batch in lockstep (measured max-lane 7x the mean at
    # dim-1020).  Capped rounds of `compact_period` iterations retire
    # finished lanes into power-of-two buckets between rounds; the caps
    # also bound each device execution.  compact_period=0 disables.
    # default OFF at B<=32: each compaction round re-runs the per-call
    # setup (equilibration + factor chain) and can hit un-warmed
    # bucket-shape compiles inside the timed path.  Pass
    # compact_period>0 explicitly for big batches.
    compact_period = kw.pop("compact_period",
                            2048 if As.shape[0] > 32 else 0)
    # phase1="ladder" (default): the whole barrier ladder in ONE f32
    # loop per lane (adjust_barrier inside the loop), where the
    # per-stage sprint pays dispatch + f64-residual overhead per barrier
    # stage for ~8 f32 iterations of work.  phase1="sprint" restores
    # the per-stage loop.
    phase1 = kw.pop("phase1", "ladder")
    if phase1 not in ("ladder", "sprint"):
        raise ValueError(f"phase1 must be 'ladder' or 'sprint'; "
                         f"got {phase1!r}")
    # prepare setup ONCE (equilibration + factors + r-vector) and share
    # it across phase 1, phase 2, and every compaction round -- each
    # otherwise re-runs the whole chain per call
    prep = kw.pop("prepared", None)
    if prep is None and kw.get("normalize"):
        prep = prepare_conic_batch(
            As, bs, cs, Q_diags, cones=kw["cones"],
            rho_y=kw.get("rho_y", 1e-6), rho_x=kw.get("rho_x", 1.0),
            rho_tau=kw.get("rho_tau", 1.0),
            precision=kw.get("precision", "f64"),
            form=kw.get("form", "auto"), normalize=True)
        kw = dict(kw, normalize=False)
    r1 = _solve_qcp_batch_jit(
        As, bs, cs, Q_diags, engine=phase1, prepared=prep,
        sprint_mu_switch=sprint_mu_switch, mu_stop=sprint_mu_switch, **kw)
    done1 = np.asarray(r1.status) != 0
    if done1.all():
        return r1

    def _resume(r):
        return (r.u_raw, r.v_raw, r.mu, r.tol_inner, r.admm_iters,
                r.ipm_iters, r.status)

    if not compact_period:
        init = _resume(r1)
        r2 = _solve_qcp_batch_jit(
            As, bs, cs, Q_diags,
            engine="delta" if endgame == "delta" else "steps",
            init_state=init, prepared=prep, **kw)
        d = jnp.asarray(done1)

        def pick(a1, a2):
            if a1 is None:
                return a2
            return jnp.where(d.reshape(d.shape + (1,) * (a1.ndim - 1)),
                             a1, a2)

        return ConicDeviceResult(*[pick(a1, a2) for a1, a2 in zip(r1, r2)])

    max_admm = kw.get("max_admm", 100_000)
    max_ipm = kw.get("max_ipm", 200)
    As_n, bs_n, cs_n = jax.device_get((As, bs, cs))
    Qd_n = None if Q_diags is None else np.asarray(jax.device_get(Q_diags))
    out = [np.array(f) for f in jax.device_get(r1)]
    state = [np.array(t) for t in jax.device_get(_resume(r1))]
    _K, _I = 4, 5                    # admm_iters / ipm_iters slots
    active = np.where(~done1)[0]

    def _bucket(size):
        b = 4
        while b < size:
            b *= 2
        return b

    while active.size:
        nb = _bucket(active.size)
        idx = active[np.arange(nb) % active.size]
        # SHARED scalar cap (see _solve_qcp_batch_jit): every
        # active lane runs to the same total-iteration rung
        caps = np.int32(min(int(state[_K][active].max()) + compact_period,
                            max_admm))
        prev_k = state[_K][active].copy()
        prev_i = state[_I][active].copy()
        r2 = ConicDeviceResult(*jax.device_get(_solve_qcp_batch_jit(
            As_n[idx], bs_n[idx], cs_n[idx],
            None if Qd_n is None else Qd_n[idx],
            engine="delta" if endgame == "delta" else "steps",
            init_state=tuple(s[idx] for s in state), k_cap=caps,
            prepared=(None if prep is None
                      else jax.tree.map(lambda a: a[idx], prep)),
            **kw)))
        live = np.arange(active.size)
        fin = ((r2.status[live] != 0)
               | (r2.admm_iters[live] >= max_admm)
               | (r2.ipm_iters[live] >= max_ipm)
               | ((r2.admm_iters[live] <= prev_k)
                  & (r2.ipm_iters[live] <= prev_i)))
        for f_out, f_new in zip(out, r2):
            f_out[active[fin]] = f_new[live][fin]
        keep = ~fin
        for s_arr, f_new in zip(state, _resume(r2)):
            s_arr[active[keep]] = np.asarray(f_new)[live][keep]
        active = active[keep]
    return ConicDeviceResult(*[jnp.asarray(f) for f in out])


@partial(jax.jit, static_argnames=("cones", "eps", "max_ipm", "max_admm",
                                   "alpha", "rho_y", "rho_x", "rho_tau",
                                   "psi", "inner_check_period", "precision",
                                   "ir_steps", "inner_crit_period",
                                   "solver", "normalize", "anchor_period",
                                   "form", "cadence", "probe_period",
                                   "engine", "sprint_mu_switch", "mu_stop"))
def _solve_qcp_batch_jit(As, bs, cs, Q_diags=None, *, cones: ConeSpec,
                         eps=1e-4, max_ipm=200, max_admm=100_000, alpha=1.8,
                         rho_y=1e-6, rho_x=1.0, rho_tau=1.0, psi=1.0,
                         inner_check_period=500, precision="f64",
                         ir_steps=1, inner_crit_period=1,
                         solver="cholesky", normalize=False,
                         anchor_period=100, form="auto",
                         cadence="chunk", probe_period=8,
                         engine="steps", sprint_mu_switch=1e-3,
                         mu_stop=0.0, init_state=None,
                         k_cap=None, prepared=None) -> ConicDeviceResult:
    """Solve a stacked batch of same-shape conic programs on device.

    As: (B, m, n); bs: (B, m); cs: (B, n); Q_diags: optional (B, n)
    diagonal or (B, n, n) FULL quadratic terms (full Q forces the
    primal Schur form; the Woodbury dual form needs H diagonal).
    normalize=True applies the host driver's cone-tied equilibration on
    device; otherwise pre-scale the data.

    max_admm is the TOTAL ADMM iteration budget across all barrier stages
    (instances hitting it return status UNFINISHED).  Note this differs
    from the host driver, where the total budget is
    max_admm_iters * max_ipm_iters (`qcp.py` k_cap) -- the device path
    needs a single hard bound because the jitted loop cannot be
    interrupted.

    precision="mixed" note: the f32 Schur factor degrades with
    cond(S) ~ 1/rho_y.  The conic reference default rho_y=1e-6 makes
    the mixed path stall below its criterion noise floor (measured); use
    rho_y >= 1e-3 with mixed precision (measured trajectory then matches
    f64: 3054 vs 3052 iterations on the probe instance), or precision
    "f64".
    """
    layout = ConeLayout(cones)

    def one(A, b, c, qd, ist, kc, prep):
        return _device_solve_qcp(
            A, b, c, qd, layout, eps=eps, max_ipm=max_ipm,
            max_admm=max_admm, alpha=alpha, rho_y=rho_y, rho_x=rho_x,
            rho_tau=rho_tau, psi=psi, inner_check_period=inner_check_period,
            precision=precision, ir_steps=ir_steps,
            inner_crit_period=inner_crit_period, solver=solver,
            normalize=normalize, anchor_period=anchor_period, form=form,
            cadence=cadence, probe_period=probe_period,
            engine=engine, sprint_mu_switch=sprint_mu_switch,
            mu_stop=mu_stop, init_state=ist, k_cap=kc, prepared=prep,
        )

    if k_cap is not None:
        k_cap = jnp.asarray(k_cap, jnp.int32)
        # callers should pass a shared scalar cap (a per-lane batched
        # cap compiled far slower at the LASSO m=1000 embedding); both
        # are supported

    # HIGHEST matmul precision: at DEFAULT precision f32 matmuls may run
    # in TF32 on the GPU, breaking the anchored-delta error budget of
    # the mixed mode (see device_solve_lp's docstring)
    with jax.default_matmul_precision("highest"):
        if (Q_diags is None and init_state is None and k_cap is None
                and prepared is None):
            return jax.vmap(lambda A, b, c: one(A, b, c, None, None,
                                                None, None))(As, bs, cs)
        qd_b = 0 if Q_diags is not None else None
        kc_b = (0 if (k_cap is not None and k_cap.ndim) else None)
        ist_b = (0,) * len(init_state) if init_state is not None else None
        pr_b = 0 if prepared is not None else None
        f = jax.vmap(
            lambda A, b, c, qd, ist, kc, prep: one(A, b, c, qd, ist, kc,
                                                   prep),
            in_axes=(0, 0, 0, qd_b, ist_b, kc_b, pr_b))
        return f(As, bs, cs, Q_diags, init_state, k_cap, prepared)


@partial(jax.jit, static_argnames=("cones", "rho_y", "rho_x", "rho_tau",
                                   "precision", "form", "normalize"))
def prepare_conic_batch(As, bs, cs, Q_diags=None, *, cones: ConeSpec,
                        rho_y=1e-6, rho_x=1.0, rho_tau=1.0,
                        precision="f64", form="auto",
                        normalize=True) -> PreparedConic:
    """Build the per-instance setup ONCE: equilibration, Schur factors,
    and the tau-quadratic precompute (`pre_calculate`,
    `source/abip.c:886-910`) as a vmappable `PreparedConic` batch.

    Pass the result to `solve_qcp_batch(..., prepared=...)` (with
    matching rho/precision/form kwargs and normalize=False implied):
    resume rounds, compaction buckets, and warm re-solves then skip the
    whole setup chain instead of re-running it per call."""
    layout = ConeLayout(cones)
    mixed = precision == "mixed"

    def one(A, b, c, Q_diag):
        m, n = A.shape
        dtype = A.dtype
        nm_b = jnp.max(jnp.abs(b)) if m else jnp.zeros((), dtype)
        nm_c = jnp.max(jnp.abs(c))
        if normalize:
            from ..qcp import conic_defaults
            from ..scaling import equilibrate_conic

            A2, Q2, b2, c2, scal = equilibrate_conic(
                A, Q_diag, b, c, layout, conic_defaults())
            D, E = scal.D, scal.E
            sc_b, sc_c = scal.sc_b, scal.sc_c
        else:
            A2, Q2, b2, c2 = A, Q_diag, b, c
            D = jnp.ones((m,), dtype)
            E = jnp.ones((n,), dtype)
            sc_b = jnp.ones((), dtype)
            sc_c = jnp.ones((), dtype)
        full_Q = Q2 is not None and Q2.ndim == 2
        if form == "auto":
            woodbury = 2 * m <= n and not full_Q
        else:
            woodbury = form == "woodbury"
        dss = DenseSchurSolver(A2, Q2, jnp.full((m,), rho_y, dtype),
                               jnp.full((n,), rho_x, dtype),
                               mode="newton" if mixed else "chol",
                               form="woodbury" if woodbury else "primal")
        r_y, r_x, _ = dss.solve(-b2, c2)
        r_vec = jnp.concatenate([r_y, r_x])
        rho_vec = jnp.concatenate([jnp.full((m,), rho_y, dtype),
                                   jnp.full((n,), rho_x, dtype)])
        a_coef = rho_tau + jnp.dot(rho_vec * r_vec, r_vec)
        return PreparedConic(A=A2, b=b2, c=c2, Q_diag=Q2, D=D, E=E,
                             sc_b=sc_b, sc_c=sc_c, nm_inf_b0=nm_b,
                             nm_inf_c0=nm_c, dss=dss, r_vec=r_vec,
                             a_coef=a_coef)

    with jax.default_matmul_precision("highest"):
        if Q_diags is None:
            return jax.vmap(lambda A, b, c: one(A, b, c, None))(As, bs, cs)
        return jax.vmap(one)(As, bs, cs, Q_diags)


@partial(jax.jit, static_argnames=("cones", "eps", "max_ipm", "max_admm",
                                   "alpha", "rho_y", "rho_x", "rho_tau",
                                   "psi", "inner_check_period", "precision",
                                   "ir_steps", "inner_crit_period",
                                   "solver", "normalize", "anchor_period",
                                   "form", "cadence", "probe_period"))
def solve_qcp_device(A, b, c, Q_diag=None, *, cones: ConeSpec,
                     eps=1e-4, max_ipm=200, max_admm=100_000, alpha=1.8,
                     rho_y=1e-6, rho_x=1.0, rho_tau=1.0, psi=1.0,
                     inner_check_period=500, precision="f64",
                     ir_steps=1, inner_crit_period=1,
                     solver="cholesky", normalize=False,
                     anchor_period=100, form="auto",
                     cadence="cond", probe_period=8) -> ConicDeviceResult:
    """Single-instance, whole-solve-in-one-program conic solve (B=1,
    un-vmapped).  Q_diag: (n,) diagonal or (n, n) full quadratic term.

    The host-pool conic analogue of `batched.device_solve_lp`: the host
    driver's sprint cadence costs several dispatches + scalar syncs per
    barrier stage, which serialize on the GIL when a thread pool runs
    many instances (measured: pooled host solves SLOWER than serial on
    the dim-204 class).  One dispatch per solve releases the GIL for the
    whole solve, so suite-level host parallelism scales."""
    # see solve_qcp_batch for the HIGHEST-precision rationale
    with jax.default_matmul_precision("highest"):
        return _device_solve_qcp(
            A, b, c, Q_diag, ConeLayout(cones), eps=eps, max_ipm=max_ipm,
            max_admm=max_admm, alpha=alpha, rho_y=rho_y, rho_x=rho_x,
            rho_tau=rho_tau, psi=psi, inner_check_period=inner_check_period,
            precision=precision, ir_steps=ir_steps,
            inner_crit_period=inner_crit_period, solver=solver,
            normalize=normalize, anchor_period=anchor_period, form=form,
            cadence=cadence, probe_period=probe_period,
        )


# ---------------------------------------------------------------------- #
# heterogeneous-cone batching                                             #
# ---------------------------------------------------------------------- #
def pad_conic_instances(problems, dtype=jnp.float64):
    """Pad a list of conic instances with DIFFERENT shapes and cone
    structures to one stacked batch.

    problems: sequence of (A, b, c, Q_or_None, ConeSpec) tuples.
    Returns (As, bs, cs, Qs, layout, dims):
      As (B, m_pad, n_pad), bs (B, m_pad), cs (B, n_pad);
      Qs None | (B, n_pad) diagonal | (B, n_pad, n_pad) full (any full
      Q promotes the whole batch -- the Woodbury form needs diagonal H);
      layout: stacked `PaddedConeLayout` (kind/seg/head are (B, n_pad)
      DATA leaves, so one compiled program serves every cone mix);
      dims: [(m_i, n_i)] natural shapes for slicing solutions back out.

    Padding is the standard inert embedding (`PaddedConeLayout` doc):
    extra columns are zero-cone elements with zero A-columns/c-entries
    (prox pins them to 0), extra rows are zero rows with b=0 (their y
    stays 0 through the rho_y-regularized projection).  This covers the
    reference's mixed-cone CBLIB protocol (`test_cblib.m:60-76`), which
    it runs one instance at a time.
    """
    import numpy as np

    from ..cones import PaddedConeLayout

    B = len(problems)
    dims = [(np.shape(p[0])[0], np.shape(p[0])[1]) for p in problems]
    m_pad = max(m for m, _ in dims)
    n_pad = max(n for _, n in dims)
    specs = [p[4] for p in problems]
    layout = PaddedConeLayout.stack(specs, n_pad=n_pad)

    any_q = any(p[3] is not None for p in problems)
    full_q = any(p[3] is not None and np.ndim(p[3]) == 2 for p in problems)
    As = np.zeros((B, m_pad, n_pad), dtype)
    bs = np.zeros((B, m_pad), dtype)
    cs = np.zeros((B, n_pad), dtype)
    if not any_q:
        Qs = None
    elif full_q:
        Qs = np.zeros((B, n_pad, n_pad), dtype)
    else:
        Qs = np.zeros((B, n_pad), dtype)
    for k, (A, b, c, Q, _spec) in enumerate(problems):
        m, n = dims[k]
        As[k, :m, :n] = np.asarray(A, dtype)
        bs[k, :m] = np.asarray(b, dtype).ravel()
        cs[k, :n] = np.asarray(c, dtype).ravel()
        if Q is None:
            continue
        Q = np.asarray(Q, dtype)
        if full_q:
            Qs[k, :n, :n] = Q if Q.ndim == 2 else np.diag(Q)
        else:
            Qs[k, :n] = Q
    return (jnp.asarray(As), jnp.asarray(bs), jnp.asarray(cs),
            None if Qs is None else jnp.asarray(Qs), layout, dims)


@partial(jax.jit, static_argnames=("eps", "max_ipm", "max_admm", "alpha",
                                   "rho_y", "rho_x", "rho_tau", "psi",
                                   "inner_check_period", "precision",
                                   "ir_steps", "inner_crit_period",
                                   "solver", "anchor_period", "form",
                                   "cadence", "probe_period"))
def _solve_qcp_het_core(As, bs, cs, Qs, layout, scalings, *, eps, max_ipm,
                        max_admm, alpha, rho_y, rho_x, rho_tau, psi,
                        inner_check_period, precision, ir_steps,
                        inner_crit_period, solver, anchor_period, form,
                        cadence, probe_period) -> ConicDeviceResult:
    def one(A, b, c, qd, lay, scal):
        return _device_solve_qcp(
            A, b, c, qd, lay, eps=eps, max_ipm=max_ipm, max_admm=max_admm,
            alpha=alpha, rho_y=rho_y, rho_x=rho_x, rho_tau=rho_tau,
            psi=psi, inner_check_period=inner_check_period,
            precision=precision, ir_steps=ir_steps,
            inner_crit_period=inner_crit_period, solver=solver,
            normalize=False, anchor_period=anchor_period, form=form,
            cadence=cadence, probe_period=probe_period, scaling=scal)

    # see solve_qcp_batch for the HIGHEST-precision rationale
    with jax.default_matmul_precision("highest"):
        if Qs is None:
            return jax.vmap(
                lambda A, b, c, lay, scal: one(A, b, c, None, lay, scal)
            )(As, bs, cs, layout, scalings)
        return jax.vmap(one)(As, bs, cs, Qs, layout, scalings)


def solve_qcp_het_batch(problems, *, eps=1e-4, max_ipm=200,
                        max_admm=100_000, alpha=1.8, rho_y=1e-6,
                        rho_x=1.0, rho_tau=1.0, psi=1.0,
                        inner_check_period=500, precision="f64",
                        ir_steps=1, inner_crit_period=1,
                        solver="cholesky", normalize=True,
                        anchor_period=100, form="auto", cadence="chunk",
                        probe_period=8, route="auto") -> ConicDeviceResult:
    """Solve a batch of conic programs with HETEROGENEOUS shapes and
    cone structures in ONE compiled program.

    problems: sequence of (A, b, c, Q_or_None, ConeSpec).  The reference
    runs its mixed-cone CBLIB suite one process per instance
    (`scripts/bench-qcp/test_cblib.m:60-76`); here the cone layout is
    lane DATA (`PaddedConeLayout`), so a single vmapped program covers
    the whole suite.

    route: "auto" (default) measures the pad-to-natural FLOP waste of
    the lockstep batch (every lane pays the max-shape matmuls every
    iteration); above 2x it dispatches the per-instance device route
    instead (shape-bucketed compiles, one program per distinct shape):
    the padded batch pays the max shape in every lane, so it is only
    the right tool for near-uniform suites.  "batch" /
    "pool" force either path.

    normalize=True equilibrates each lane ON HOST at its natural shape
    (identical math to the host driver / `solve_qcp_batch(normalize=
    True)`), pads the scaled data, and ships the per-lane scalings as
    batch data -- residual checks and returned solutions refer to the
    ORIGINAL data, exactly as the reference's `calc_residuals` does.

    Returns a `ConicDeviceResult` with padded (B, n_pad)/(B, m_pad)
    solution arrays; slice lane k with its natural dims (padding is
    exactly zero).
    """
    import numpy as np

    from ..qcp import conic_defaults
    from ..scaling import equilibrate_conic

    if route not in ("auto", "batch", "pool"):
        raise ValueError(f"route must be 'auto', 'batch', or 'pool'; "
                         f"got {route!r}")
    if route == "auto":
        m_pad_est = max(a.shape[0] for a, *_ in problems)
        n_pad_est = max(a.shape[1] for a, *_ in problems)
        nat = sum(a.shape[0] * a.shape[1] for a, *_ in problems)
        waste = len(problems) * m_pad_est * n_pad_est / max(nat, 1)
        route = "pool" if waste > 2.0 else "batch"
    if route == "pool":
        return _solve_qcp_het_pool(
            problems, eps=eps, max_ipm=max_ipm, max_admm=max_admm,
            alpha=alpha, rho_y=rho_y, rho_x=rho_x, rho_tau=rho_tau,
            psi=psi, inner_check_period=inner_check_period,
            precision=precision, ir_steps=ir_steps,
            inner_crit_period=inner_crit_period, solver=solver,
            normalize=normalize, anchor_period=anchor_period, form=form,
            cadence=cadence, probe_period=probe_period)

    dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    if normalize:
        scaled, scal_rows = [], []
        for (A, b, c, Q, spec) in problems:
            A = jnp.asarray(A, dtype)
            b = jnp.asarray(b, dtype)
            c = jnp.asarray(c, dtype)
            Qj = None if Q is None else jnp.asarray(Q, dtype)
            nm_b0 = jnp.max(jnp.abs(b)) if b.shape[0] else jnp.zeros((), dtype)
            nm_c0 = jnp.max(jnp.abs(c))
            lay = ConeLayout(spec)
            As_, Qs_, bs_, cs_, sc = equilibrate_conic(
                A, Qj, b, c, lay, conic_defaults())
            scaled.append((np.asarray(As_), np.asarray(bs_),
                           np.asarray(cs_),
                           None if Qs_ is None else np.asarray(Qs_), spec))
            scal_rows.append((np.asarray(sc.D), np.asarray(sc.E),
                              float(sc.sc_b), float(sc.sc_c),
                              float(nm_b0), float(nm_c0)))
        problems = scaled
    else:
        scal_rows = None

    As, bs, cs, Qs, layout, dims = pad_conic_instances(problems, dtype)
    B, m_pad = bs.shape
    n_pad = cs.shape[1]
    D = np.ones((B, m_pad), dtype)
    E = np.ones((B, n_pad), dtype)
    sc_b = np.ones((B,), dtype)
    sc_c = np.ones((B,), dtype)
    nm_b0 = np.asarray(np.max(np.abs(np.asarray(bs)), axis=1), dtype)
    nm_c0 = np.asarray(np.max(np.abs(np.asarray(cs)), axis=1), dtype)
    if scal_rows is not None:
        for k, (Dk, Ek, sbk, sck, nbk, nck) in enumerate(scal_rows):
            D[k, : Dk.shape[0]] = Dk
            E[k, : Ek.shape[0]] = Ek
            sc_b[k], sc_c[k] = sbk, sck
            nm_b0[k], nm_c0[k] = nbk, nck
    scalings = (jnp.asarray(D), jnp.asarray(E), jnp.asarray(sc_b),
                jnp.asarray(sc_c), jnp.asarray(nm_b0), jnp.asarray(nm_c0))
    return _solve_qcp_het_core(
        As, bs, cs, Qs, layout, scalings, eps=eps, max_ipm=max_ipm,
        max_admm=max_admm, alpha=alpha, rho_y=rho_y, rho_x=rho_x,
        rho_tau=rho_tau, psi=psi, inner_check_period=inner_check_period,
        precision=precision, ir_steps=ir_steps,
        inner_crit_period=inner_crit_period, solver=solver,
        anchor_period=anchor_period, form=form, cadence=cadence,
        probe_period=probe_period)


def _solve_qcp_het_pool(problems, *, normalize, **kw) -> ConicDeviceResult:
    """Per-instance device route for heterogeneous suites (the winning
    side of the r04 hardware measurement): one `solve_qcp_device`
    program per DISTINCT shape/cone spec, results re-padded to the
    het-batch contract so callers see the same `ConicDeviceResult`."""
    import numpy as np

    m_pad = max(a.shape[0] for a, *_ in problems)
    n_pad = max(a.shape[1] for a, *_ in problems)
    outs = []
    for (A, b, c, Q, spec) in problems:
        outs.append(solve_qcp_device(
            jnp.asarray(A), jnp.asarray(b), jnp.asarray(c),
            None if Q is None else jnp.asarray(Q), cones=spec,
            normalize=normalize, **kw))

    def padded(field, width):
        rows = []
        for r in outs:
            v = np.asarray(getattr(r, field))
            rows.append(np.pad(v, (0, width - v.shape[0])))
        return jnp.asarray(np.stack(rows))

    def scalar(field):
        return jnp.asarray(np.stack(
            [np.asarray(getattr(r, field)) for r in outs]))

    return ConicDeviceResult(
        x=padded("x", n_pad), y=padded("y", m_pad), s=padded("s", n_pad),
        status=scalar("status"), ipm_iters=scalar("ipm_iters"),
        admm_iters=scalar("admm_iters"), res_pri=scalar("res_pri"),
        res_dual=scalar("res_dual"), rel_gap=scalar("rel_gap"),
        pobj=scalar("pobj"), dobj=scalar("dobj"))


def host_polish(A, b, c, cones: ConeSpec, result: ConicDeviceResult,
                lane=0, *, eps, Q=None, mu_floor=1e-12, **overrides):
    """Finish a Solved/Inaccurate batch lane in native f64.

    The anchored-f32 engines floor the primal residual at roughly
    sqrt(q)*eps32 on wide embeddings (q >= 2e4), so the LAST barrier
    stage runs in the f64 host-loop driver on the default device:
    rebuild the workspace (its own equilibration), invert its scaling
    for the batch lane's unscaled (x, y, s)
    (`ConicWorkspace._warm_start`), and resume at the lane's barrier
    state through the checkpoint seam.  This is the same init/solve
    split the reference exposes for repeated solves
    (`src/abip-qcp/source/abip.c:1271-1311`).  Returns the host
    driver's `ConicSolution` (status/residuals re-certified in f64).
    """
    from ..qcp import ConicWorkspace, conic_defaults
    from ..utils.checkpoint import ConicCheckpoint

    x = np.asarray(result.x[lane], np.float64)
    y = np.asarray(result.y[lane], np.float64)
    s = np.asarray(result.s[lane], np.float64)
    k0 = int(np.asarray(result.admm_iters[lane]))
    stgs = conic_defaults(eps=eps, **overrides)
    # Resume mu CLAMPED BELOW by the target tolerance: the batch
    # engines' stage-stall guard advances the barrier WITHOUT converging the
    # stalled stages, so its final mu (as low as eps*1e-3) describes a
    # stage the iterate never earned.  Resuming there hands the host a
    # stiff near-zero-barrier subproblem with a near-zero inner
    # tolerance (measured: ~25 CPU-minutes of grinding at m=1000,
    # n=10000).  mu = max(mu_dev, eps) restarts at an honest final
    # stage; the host ladder then drives mu down only as its stages
    # actually converge (`adjust_barrier`, `source/abip.c:994-1071`).
    mu = min(max(float(np.asarray(result.mu[lane])), mu_floor, eps), 1.0)
    tol_inner = 4.0 * mu ** stgs.psi

    w = ConicWorkspace(np.asarray(A, np.float64), np.asarray(b, np.float64),
                       np.asarray(c, np.float64), cones, Q=Q, settings=stgs)
    u, v = w._warm_start((x, y, s), mu, 1.0)
    ck = ConicCheckpoint(u=np.asarray(u), v=np.asarray(v), mu=mu,
                         tol_inner=tol_inner, admm_iters=k0, ipm_iters=0)
    return w.solve(resume=ck)
