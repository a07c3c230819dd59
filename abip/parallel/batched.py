"""Fully-on-device LP solver for batched suite runs.

The host-driven solver (`lp.py`) syncs once per barrier stage to run the
mu-schedule tables -- the right trade for one instance.  For a SUITE of
instances (the reference's benchmark mode, run as separate processes,
`scripts/bench-lp/run_all_abip.sh`), the device design is one XLA
program: outer IPM loop AND inner ADMM loop as nested `lax.while_loop`s,
`vmap`ped over stacked instances with per-instance convergence masking
(SURVEY.md section 5.7).  The mu rule is the default hybrid
aggressive->LOQO pair (`abip.c:2251-2277`), which is pure jnp -- the
tabulated "tedious" schedule stays a host-side luxury.

Precision modes
---------------
`precision="f64"` runs every operation in f64.  `precision="mixed"`
keeps the ITERATE in f64 but applies every matrix operation through a
per-stage ANCHOR:

    A @ x  =  [A_64 @ x_anchor]_cached  +  f64( A_32 @ f32(x - x_anchor) )

The anchor is refreshed once per barrier stage (one f64-quality pass);
inside the stage the deltas are small, so the f32 matmul error
(~1e-7 * ||x - x_anchor||) stays below the f64 iterate's own noise.  The
KKT solve anchors the same way (f32 Cholesky on the delta + one iterative-
refinement step against the f64 normal matrix).  Convergence trajectories
match the pure-f64 solver iteration-for-iteration on the smoke suite,
at f32 throughput.

Everything reuses the shared step math in `abip.hsd`.
"""
from __future__ import annotations

from functools import lru_cache as _lru_cache, partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import hsd
from ..scaling import equilibrate, normalize_bc
from ..settings import Settings

f32 = jnp.float32
f64 = jnp.float64


class DeviceSolveResult(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray
    s: jnp.ndarray
    status: jnp.ndarray        # int32: 1 solved, -1 unbounded, -2 infeasible, 0 unfinished
    ipm_iters: jnp.ndarray
    admm_iters: jnp.ndarray
    res_pri: jnp.ndarray
    res_dual: jnp.ndarray
    rel_gap: jnp.ndarray
    pobj: jnp.ndarray
    dobj: jnp.ndarray
    # raw internal state (scaled space), for phase hand-off (mu_stop /
    # init_state -- see the two-phase sprint driver in solve_lp_batch)
    u_raw: jnp.ndarray = None
    v_raw: jnp.ndarray = None
    mu: jnp.ndarray = None
    # stage-average accumulators, carried across resume boundaries so a
    # mid-stage hand-off (k_cap round in the compacted phase-2 driver)
    # does not reset the running average -- the reset was the straggler
    # blow-up fixed in the C-carry docstring below
    u_sum_raw: jnp.ndarray = None
    v_sum_raw: jnp.ndarray = None
    sj: jnp.ndarray = None


class _Anchor(NamedTuple):
    """Per-stage anchor for mixed-precision operator application."""

    x0: jnp.ndarray    # (n,) matvec operand anchor
    y0: jnp.ndarray    # (m,) rmatvec operand anchor
    Ax0: jnp.ndarray   # f64 A @ x0
    ATy0: jnp.ndarray  # f64 A' @ y0
    w0: jnp.ndarray    # (n,) rhs-fold operand anchor
    Aw0: jnp.ndarray   # f64 A @ w0
    z0: jnp.ndarray    # (m,) KKT solution anchor
    ATz0: jnp.ndarray  # f64 A' @ z0
    q0: jnp.ndarray    # (m,) normal-equations rhs anchor


_LP_STATIC = ("eps", "max_ipm", "max_admm", "alpha",
              "rho_y", "normalize", "scale", "ruiz_iter",
              "hybrid_thresh", "dynamic_x", "dynamic_eta",
              "shrink_second", "gamma0", "sigma0",
              "precision", "ir_steps", "solver",
              "engine", "sprint_T", "sprint_mu_switch",
              "qres_period", "anchor_period",
              "avg_period", "cadence", "probe_period",
              "mu_stop")


@partial(jax.jit, static_argnames=_LP_STATIC)
def device_solve_lp(A, b, c, *, init_state=None, k_cap=None,
                    **opts) -> DeviceSolveResult:
    """Solve one standard-form LP entirely on device.  vmap-able.

    Traced under `jax.default_matmul_precision("highest")`: at DEFAULT
    precision an accelerator may round f32 matmul operands (TF32 on the
    GPU, ~1e-3 relative error), which silently breaks the anchored-delta
    error budget of the mixed mode (the design assumes ~1e-7 f32 matvec
    error) -- the KKT apply, the IR correction, and the qres probes all
    lose accuracy and marginal/degenerate lanes take 20-60x the
    host-parity ADMM count in the endgame.  HIGHEST keeps f32 products
    f32, as the sprint engine does (`ops/admm_sprint._dot_t`).  See
    `_device_solve_lp_impl` for the full option list and semantics.
    """
    with jax.default_matmul_precision("highest"):
        return _device_solve_lp_impl(A, b, c, init_state=init_state,
                                     k_cap=k_cap, **opts)


def _device_solve_lp_impl(A, b, c, *, eps=1e-6, max_ipm=200, max_admm=200_000,
                          alpha=1.8, rho_y=1e-3, normalize=True, scale=1.0,
                          ruiz_iter=10, hybrid_thresh=1000.0, dynamic_x=0.8,
                          dynamic_eta=1.1, shrink_second=0.5, gamma0=2.0,
                          sigma0=0.3, precision="f64", ir_steps=1,
                          solver="cholesky", engine="steps", sprint_T=32,
                          sprint_mu_switch=1e-3,
                          qres_period=1, anchor_period=1000,
                          avg_period=10, cadence="cond",
                          probe_period=8, mu_stop=0.0,
                          init_state=None, k_cap=None) -> DeviceSolveResult:
    """Solve one standard-form LP entirely on device.  vmap-able.

    engine="sprint" (mixed precision only) runs `sprint_T` whole f32 ADMM
    iterations per loop through `ops.admm_sprint.fused_admm_sprint`
    while mu > `sprint_mu_switch` (the bulk of the iterations), dropping
    to the anchored per-iteration path for the accuracy endgame.

    qres_period=P evaluates the inner stopping criterion (2 matvecs,
    `iterate_Q_norm_resd` in the reference, checked every iteration
    there) only every P-th iteration: each stage may overrun by at most
    P-1 iterations, in exchange for cutting the per-iteration matvec
    count.  P=1 reproduces the reference cadence exactly.

    avg_period=Pa evaluates the cumulative-average candidate (2 extra
    matvecs) and, in mixed mode, the full residual check, every Pa-th
    iteration (reference cadence: every 10th via `compute_avg`
    consumers).

    cadence="cond" (default) gates the periodic checks with
    `lax.cond` -- real branching when the program is NOT vmapped, so
    single-instance solves pay nothing between checks.  Under `vmap`,
    XLA lowers `cond` to compute-both-branches + select, which silently
    re-enables the f64 residual check on EVERY iteration of EVERY
    lane.
    cadence="chunk" makes the cadence structural instead: each
    while-loop trip runs up to `qres_period` uniform lean iterations in
    micro-trips of `probe_period` (a nested `lax.while_loop` of
    `lax.fori_loop`s), probing the CHEAP inner criterion -- anchored
    qres on the current and averaged iterates -- after every micro-trip
    and exiting as soon as it fires, then performs the EXPENSIVE
    true-f64 residual check exactly once, unconditionally.  Stage
    overrun is bounded by probe_period-1 iterations (matching the
    reference's every-iteration inner stop `abip.c:2131-2173` to within
    the probe granularity) while the f64 check stays amortized over up
    to qres_period iterations.  avg/residual checks ride the chunk
    boundary, so avg_period is ignored in chunk mode.  `solve_lp_batch`
    defaults to chunk.
    """
    if precision not in ("f64", "mixed"):
        raise ValueError(f"precision must be 'f64' or 'mixed'; got {precision!r}")
    if engine not in ("steps", "sprint", "delta"):
        raise ValueError(
            f"engine must be 'steps', 'sprint', or 'delta'; got {engine!r}")
    if engine == "sprint" and precision != "mixed":
        raise ValueError("engine='sprint' requires precision='mixed'")
    if engine == "delta" and cadence != "chunk":
        raise ValueError("engine='delta' requires cadence='chunk'")
    # cadence knobs must be >= 1: anchor_period < 1 in mixed mode makes the
    # jitted outer loop non-terminating (stage_cap=0 => j stays 0, cap_exit
    # re-anchors forever without advancing k), and period 0 is a traced
    # modulo-by-zero
    if qres_period < 1 or avg_period < 1 or anchor_period < 1 \
            or probe_period < 1:
        raise ValueError(
            "qres_period, avg_period, anchor_period, and probe_period must "
            f"be >= 1; got {qres_period}, {avg_period}, {anchor_period}, "
            f"{probe_period}")
    if cadence not in ("cond", "chunk"):
        raise ValueError(f"cadence must be 'cond' or 'chunk'; got {cadence!r}")
    chunked = cadence == "chunk"
    sprint = engine == "sprint"
    delta = engine == "delta"
    # per-call ADMM-iteration ceiling: a TRACED operand (unlike the
    # static max_admm), so the compacted phase-2 driver can run capped
    # rounds without recompiling per cap value
    if k_cap is None:
        kcap = jnp.asarray(max_admm, jnp.int32)
    else:
        kcap = jnp.minimum(jnp.asarray(k_cap, jnp.int32), max_admm)
    A = A.astype(f64)
    b = b.astype(f64)
    c = c.astype(f64)
    dtype = f64
    m, n = A.shape
    l = m + n + 1
    mixed = precision == "mixed"

    # -- setup (equilibration + b/c normalization + cached factor) ----------
    nm_b0 = jnp.linalg.norm(b)
    nm_c0 = jnp.linalg.norm(c)
    if normalize:
        stg = Settings(pc_ruiz_rescale=True, origin_rescale=False,
                       qp_rescale=False, ruiz_iter=ruiz_iter, scale=scale)
        A_s, scal = equilibrate(A, stg)
        b_s, c_s, sc_b, sc_c = normalize_bc(scal, b, c, scale)
        D, E = scal.D, scal.E
    else:
        A_s, b_s, c_s = A, b, c
        D = jnp.ones((m,), dtype)
        E = jnp.ones((n,), dtype)
        sc_b = jnp.ones((), dtype)
        sc_c = jnp.ones((), dtype)

    pr_scale = D / (sc_b * scale)
    dr_scale = E / (sc_c * scale)
    obj_scale = scale * sc_c * sc_b

    N64 = rho_y * jnp.eye(m, dtype=dtype) + A_s @ A_s.T
    chol64 = jax.lax.linalg.cholesky(N64)
    A32 = A_s.astype(f32)
    chol32 = chol64.astype(f32)
    if sprint:
        # the fused sprint applies N^-1 as one matmul
        Ninv32_sprint = jax.scipy.linalg.cho_solve(
            (chol64, True), jnp.eye(m, dtype=dtype)).astype(f32)
    if solver == "inverse":
        # explicit inverse: applying N^-1 becomes ONE matmul (batches well,
        # fuses under vmap) instead of two sequential triangular solves;
        # accuracy restored by the same IR steps against N64
        Ninv32 = jax.scipy.linalg.cho_solve(
            (chol64, True), jnp.eye(m, dtype=dtype)).astype(f32)

        def solve32(r32):
            return Ninv32 @ r32
    else:
        def solve32(r32):
            return jax.scipy.linalg.cho_solve((chol32, True), r32)

    def solve64(rhs):
        return jax.scipy.linalg.cho_solve((chol64, True), rhs)

    if delta:
        # explicit f64-quality inverse from f32 factors: f32 Cholesky +
        # two Newton steps X <- X + X(I - N X) against the f64 normal
        # matrix; each step squares the residual (cond*eps32 ~ 1e-4 ->
        # 1e-8 -> 1e-16), so two steps reach f64 roundoff for cond(N) up
        # to ~1e3.  The per-chunk anchor solve is then one f64 matvec,
        # and the f32 copy is the delta kernel's Ninv operand.
        chol32_d = jax.lax.linalg.cholesky(N64.astype(f32))
        Xd = jax.scipy.linalg.cho_solve(
            (chol32_d, True), jnp.eye(m, dtype=f32)).astype(dtype)
        eye64 = jnp.eye(m, dtype=dtype)
        for _ in range(2):
            Xd = Xd + Xd @ (eye64 - N64 @ Xd)
        Ninv64_delta = Xd
        Ninv32_delta = Ninv64_delta.astype(f32)

        def solve64_delta(rhs):
            # explicit-inverse application is not backward stable
            # (`linsys/schur._ir_apply`): one f64 vector-IR step against
            # N64 restores backward stability for cond(N) beyond the
            # ~1e3 Newton budget at the cost of two f64 matvecs per
            # anchor solve (per-chunk, not per-iteration -- negligible)
            z = Ninv64_delta @ rhs
            return z + Ninv64_delta @ (rhs - N64 @ z)

        # every f64 solve in this engine rides the Newton inverse, so
        # the f64 Cholesky/trisolve ops above become dead code (XLA DCE)
        solve64 = solve64_delta

    matvec64 = lambda x: A_s @ x
    rmatvec64 = lambda y: A_s.T @ y

    h = jnp.concatenate([-b_s, c_s])
    g_y = solve64(h[:m] + A_s @ h[m:])
    g_x = A_s.T @ g_y - h[m:]
    g = jnp.concatenate([g_y, -g_x])
    g_th = jnp.dot(h, g)

    def rank1_correct(u, v):
        """The rhs build of `project_lin_sys` (`abip.c:539-558`)."""
        r = u + v
        q = jnp.concatenate([rho_y * r[:m], r[m : m + n]])
        q = q - r[l - 1] * h
        q = q - (jnp.dot(q, g) / (g_th + 1.0)) * h
        return q, r[l - 1]

    def make_anchor(u, v) -> _Anchor:
        """One f64-quality pass per barrier stage."""
        x0 = u[m : m + n]
        y0 = u[:m]
        q, _ = rank1_correct(u, v)
        w0 = -q[m:]
        Aw0 = A_s @ w0
        q0 = q[:m] + Aw0
        z0 = solve64(q0)
        return _Anchor(x0=x0, y0=y0, Ax0=A_s @ x0, ATy0=A_s.T @ y0,
                       w0=w0, Aw0=Aw0, z0=z0, ATz0=A_s.T @ z0, q0=q0)

    def make_ops(anc: _Anchor):
        """Operator set for one stage: direct f64 or anchored f32."""
        if not mixed:
            def project(u, v, k):
                q, r_tau = rank1_correct(u, v)
                wx = -q[m:]
                z_y = solve64(q[:m] + A_s @ wx)
                z_x = A_s.T @ z_y - wx
                z = jnp.concatenate([z_y, z_x])
                tau_t = r_tau + jnp.dot(z, h)
                return jnp.concatenate([z, tau_t[None]])

            return matvec64, rmatvec64, project

        def amv(x):
            return anc.Ax0 + (A32 @ (x - anc.x0).astype(f32)).astype(f64)

        def armv(y):
            return anc.ATy0 + (A32.T @ (y - anc.y0).astype(f32)).astype(f64)

        def project(u, v, k):
            q, r_tau = rank1_correct(u, v)
            wx = -q[m:]
            rhs = q[:m] + anc.Aw0 + (A32 @ (wx - anc.w0).astype(f32)).astype(f64)
            dz = solve32((rhs - anc.q0).astype(f32)).astype(f64)
            z_y = anc.z0 + dz
            for _ in range(ir_steps):
                resid = rhs - N64 @ z_y
                z_y = z_y + solve32(resid.astype(f32)).astype(f64)
            z_x = anc.ATz0 + (A32.T @ (z_y - anc.z0).astype(f32)).astype(f64) - wx
            z = jnp.concatenate([z_y, z_x])
            tau_t = r_tau + jnp.dot(z, h)
            return jnp.concatenate([z, tau_t[None]])

        return amv, armv, project

    def residuals(u, v, mv, rmv):
        return hsd.lp_residuals(u, v, mv, rmv, b_s, c_s, pr_scale,
                                dr_scale, obj_scale, nm_b0, nm_c0, m, n)

    # -- state --------------------------------------------------------------
    u0 = jnp.concatenate([jnp.zeros((m,), dtype), jnp.ones((l - m,), dtype)])

    class C(NamedTuple):
        u: jnp.ndarray
        v: jnp.ndarray
        mu: jnp.ndarray
        i: jnp.ndarray
        k: jnp.ndarray
        final_check: jnp.ndarray
        status: jnp.ndarray
        res: hsd.LPResiduals
        # stage-average state carried ACROSS anchor re-caps: mixed mode
        # chops a barrier stage into stage_cap-iteration anchor segments
        # (drift control), but hard stages only exit through the
        # AVERAGED-iterate criterion (the last ADMM iterate can cycle on
        # degenerate LPs while the running average converges,
        # `abip.c:2125-2129`).  Resetting the average at each cap-exit
        # stalled such stages indefinitely: measured 246k iterations vs
        # 9,224 for f64 on the same instance, identical across
        # ir_steps/solver variants on one degenerate smoke lane;
        # carrying u_sum/v_sum/sj across re-anchors restores the f64
        # trajectory exactly.
        u_sum: jnp.ndarray
        v_sum: jnp.ndarray
        sj: jnp.ndarray

    class IC(NamedTuple):
        u: jnp.ndarray
        v: jnp.ndarray
        u_sum: jnp.ndarray
        v_sum: jnp.ndarray
        avg_crit: jnp.ndarray
        j: jnp.ndarray
        k: jnp.ndarray
        qres: jnp.ndarray
        status: jnp.ndarray
        res: hsd.LPResiduals

    def inner_delta(carry: C):
        """One barrier stage driven by the anchored-delta chunk
        (`ops/admm_delta.py`): each while trip runs ONE delta chunk of
        up to qres_period f32 iterations (re-anchored at every
        chunk entry, so no anchor_period cap is needed), then the
        f64-authority residual check -- the same chunk structure as
        `steps_chunk`/`sprint_chunk` at f32-sprint per-iteration cost.

        The traced `kcap` is only enforced BETWEEN chunks (the chunk's
        T is static), so a capped lane may overrun its cap by up to
        qres_period-1 iterations -- the compaction driver's round
        accounting tolerates the overshoot (it checks >=, not ==)."""
        from ..ops.admm_delta import run_delta_chunk

        mu = carry.mu
        probe = min(probe_period, qres_period)

        def cond(s: IC):
            return ((s.qres >= gamma0 * mu) & (s.status == 0)
                    & (s.k < kcap))

        def body(s: IC):
            res = run_delta_chunk(
                A_s, solve64_delta, h, g, g_th, rho_y, mu, alpha,
                gamma0 * mu, s.u, s.v, s.u_sum, s.v_sum,
                carry.sj + s.j, s.qres, T=qres_period, probe=probe,
                A32=A32, Ninv32=Ninv32_delta)
            dom = jnp.maximum(
                (carry.sj + s.j + res.t_done).astype(res.u.dtype), 1.0)
            u_sel = jnp.where(res.avg_crit, res.u_sum / dom, res.u)
            v_sel = jnp.where(res.avg_crit, res.v_sum / dom, res.v)
            r = residuals(u_sel, v_sel, matvec64, rmatvec64)
            st = jnp.where(
                carry.final_check,
                hsd.lp_converged_code(
                    r, eps, False,
                    (carry.i > 0) & (s.k + res.t_done > 0)),
                0,
            ).astype(jnp.int32)
            return IC(u=res.u, v=res.v, u_sum=res.u_sum,
                      v_sum=res.v_sum, avg_crit=res.avg_crit,
                      j=s.j + res.t_done, k=s.k + res.t_done,
                      qres=res.qres, status=st, res=r)

        init = IC(u=carry.u, v=carry.v, u_sum=carry.u_sum,
                  v_sum=carry.v_sum,
                  avg_crit=jnp.zeros((), bool),
                  j=jnp.zeros((), jnp.int32),
                  k=carry.k, qres=jnp.full((), jnp.inf, dtype),
                  status=jnp.zeros((), jnp.int32), res=carry.res)
        return (jax.lax.while_loop(cond, body, init),
                matvec64, rmatvec64)

    def inner(carry: C):
        """One barrier stage: inner ADMM while_loop (`abip.c:2131-2215`),
        with the cumulative-average candidate (`compute_avg` `:635-659`,
        `iterate_Q_norm_resd` `:1999-2050`)."""
        if delta:
            return inner_delta(carry)
        mu = carry.mu
        anc = make_anchor(carry.u, carry.v)
        mv, rmv, project = make_ops(anc)

        def qres_of(u, v):
            return hsd.q_norm_resd(u, v, mv, rmv, b_s, c_s, m, n)

        # mixed mode: cap per-anchor trips -- anchored f32 deltas lose
        # accuracy as iterates drift from the stage anchor (see the
        # conic driver's identical guard; NaN blow-ups measured there on
        # long stages).  Cap-exit re-anchors without touching mu/reinit.
        stage_cap = anchor_period if mixed else max_admm

        def cond(s: IC):
            return (
                (s.qres >= gamma0 * mu)
                & (s.status == 0)
                & (s.k < kcap)
                & (s.j < stage_cap)
            )

        def body(s: IC):
            if sprint:
                from ..ops.admm_sprint import fused_admm_sprint

                h_pad = jnp.concatenate([h, jnp.zeros((1,), dtype)])
                g_pad = jnp.concatenate([g, jnp.zeros((1,), dtype)])

                def sprint_branch(args):
                    su, sv = args
                    u32, v32 = fused_admm_sprint(
                        A32, Ninv32_sprint, h_pad.astype(f32),
                        g_pad.astype(f32), rho_y, g_th, mu, alpha,
                        su.astype(f32), sv.astype(f32), T=sprint_T)
                    return (u32.astype(f64), v32.astype(f64),
                            jnp.asarray(sprint_T, jnp.int32))

                def step_branch(args):
                    su, sv = args
                    u_t = project(su, sv, s.k)
                    u, v = hsd.admm_update(su, sv, su, u_t, mu, alpha, m)
                    return u, v, jnp.asarray(1, jnp.int32)

                # sprint through the bulk; per-iteration anchored steps for
                # the accuracy endgame
                u, v, dk = jax.lax.cond(mu > sprint_mu_switch,
                                        sprint_branch, step_branch,
                                        (s.u, s.v))
            else:
                u_t = project(s.u, s.v, s.k)
                u, v = hsd.admm_update(s.u, s.v, s.u, u_t, mu, alpha, m)
                dk = jnp.asarray(1, jnp.int32)

            u_sum = s.u_sum + u
            v_sum = s.v_sum + v
            dom = (carry.sj + s.j + 1).astype(u.dtype)
            # the running average is only consumed at check points; the
            # divides live inside the conds so the common iteration body
            # stays sums-only

            def q_update(_):
                q_cur = qres_of(u, v)

                def with_avg(_):
                    q_avg = qres_of(u_sum / dom, v_sum / dom)
                    better = q_avg < q_cur
                    return jnp.where(better, q_avg, q_cur), better

                def without_avg(_):
                    return q_cur, jnp.zeros((), bool)

                return jax.lax.cond(
                    (s.j + 1) % avg_period == 0, with_avg, without_avg, None
                )

            if qres_period == 1:
                qres, avg_crit = q_update(None)
            else:
                # stale qres between checks: the stage overruns by at most
                # qres_period-1 iterations past the true stopping point
                do_q = (((s.j + 1) % qres_period == 0)
                        | ((s.j + 1) % avg_period == 0))
                qres, avg_crit = jax.lax.cond(
                    do_q, q_update, lambda _: (s.qres, s.avg_crit), None
                )

            def check(_):
                u_sel = jnp.where(avg_crit, u_sum / dom, u)
                v_sel = jnp.where(avg_crit, v_sum / dom, v)
                # TRUE f64 products for the residual CHECK, never the
                # anchored f32 deltas: f32 matmul accumulation error
                # (~sqrt(n)*eps32) floors the measured residual near
                # 1e-6 at n ~ 1000+, stalling the solve even when the
                # iterate is long converged (measured on the conic
                # driver: reported pres 1.4e-6 vs true 6e-13).  The
                # avg_period cadence amortizes the f64 cost.
                r = residuals(u_sel, v_sel, matvec64, rmatvec64)
                st = hsd.lp_converged_code(r, eps, False,
                                           (carry.i > 0) & (s.k > 0))
                return r, st

            def no_check(_):
                return s.res, jnp.zeros((), jnp.int32)

            # mixed mode checks only every avg_period-th iteration to
            # keep the body lean (bounded overshoot of avg_period-1)
            do_res = carry.final_check & (
                ((s.j + 1) % avg_period == 0) if mixed else True)
            r, st = jax.lax.cond(do_res, check, no_check, None)
            return IC(u=u, v=v, u_sum=u_sum, v_sum=v_sum,
                      avg_crit=avg_crit,
                      j=s.j + 1, k=s.k + dk, qres=qres, status=st, res=r)

        def body_chunk(s: IC):
            """One structural chunk WITH an in-chunk stop: micro-trips
            of `probe_period` uniform lean iterations (`lax.fori_loop`),
            each followed by the CHEAP inner-criterion probe -- the
            anchored-f32-backed `qres_of` on the current AND averaged
            iterate (4 anchored matvecs per trip, ~17% of the trip's
            lean work at probe=8).  The stage therefore stops within
            probe_period-1 iterations of its true stopping point
            (`abip.c:2131-2173` checks every iteration; the r02 cadence
            without this stop inflated mean iteration counts ~4x at
            qres_period=768).  The EXPENSIVE true-f64 residual/status
            check still runs once per chunk exit, at most qres_period
            iterations apart.  No data-dependent gating outside loop
            conds, so `vmap` cannot degrade the cadence into
            compute-both-branches selects (see the cadence note in the
            driver docstring)."""
            probe = min(probe_period, qres_period)

            def finish(u, v, u_sum, v_sum, dj, dk, qres, avg_crit):
                # TRUE f64 residual check (see the cond-path comment),
                # paid once per chunk exit instead of per iteration
                dom = jnp.maximum((carry.sj + s.j + dj).astype(u.dtype), 1.0)
                u_sel = jnp.where(avg_crit, u_sum / dom, u)
                v_sel = jnp.where(avg_crit, v_sum / dom, v)
                r = residuals(u_sel, v_sel, matvec64, rmatvec64)
                st = jnp.where(
                    carry.final_check,
                    hsd.lp_converged_code(r, eps, False,
                                          (carry.i > 0) & (s.k + dk > 0)),
                    0,
                ).astype(jnp.int32)
                return IC(u=u, v=v, u_sum=u_sum, v_sum=v_sum,
                          avg_crit=avg_crit, j=s.j + dj, k=s.k + dk,
                          qres=qres, status=st, res=r)

            def steps_chunk(s):
                """Anchored per-iteration micro-trips with the cheap
                qres probe every `probe` iterations."""
                def lean(_, t):
                    u, v, us, vs = t
                    u_t = project(u, v, s.k)
                    u, v = hsd.admm_update(u, v, u, u_t, mu, alpha, m)
                    return (u, v, us + u, vs + v)

                def micro_cond(t):
                    _u, _v, _us, _vs, dj, dk, q, _ac = t
                    return ((q >= gamma0 * mu) & (dk < qres_period)
                            & (s.j + dj < stage_cap)
                            & (s.k + dk < kcap))

                def micro_body(t):
                    u, v, us, vs, dj, dk, _q, _ac = t
                    u, v, us, vs = jax.lax.fori_loop(
                        0, probe, lean, (u, v, us, vs))
                    dj = dj + probe
                    dk = dk + probe
                    dom = jnp.maximum((carry.sj + s.j + dj).astype(u.dtype), 1.0)
                    q_cur = qres_of(u, v)
                    q_avg = qres_of(us / dom, vs / dom)
                    avg_crit = q_avg < q_cur
                    q = jnp.where(avg_crit, q_avg, q_cur)
                    return (u, v, us, vs, dj, dk, q, avg_crit)

                z32 = jnp.zeros((), jnp.int32)
                u, v, u_sum, v_sum, dj, dk, qres, avg_crit = \
                    jax.lax.while_loop(
                        micro_cond, micro_body,
                        (s.u, s.v, s.u_sum, s.v_sum, z32, z32,
                         s.qres, s.avg_crit))
                return finish(u, v, u_sum, v_sum, dj, dk, qres, avg_crit)

            def sprint_chunk(s):
                """The whole chunk in one f32 loop: up to qres_period
                iterations with the qres stop every `probe` iterations
                (`ops.admm_sprint.fused_admm_sprint_stop`)."""
                from ..ops.admm_sprint import fused_admm_sprint_stop

                u32, v32, t_done, q32 = fused_admm_sprint_stop(
                    A32, Ninv32_sprint, h.astype(f32), g.astype(f32),
                    rho_y, g_th, mu, alpha, gamma0 * mu,
                    s.u.astype(f32), s.v.astype(f32),
                    T=qres_period, probe=probe)
                u = u32.astype(f64)
                v = v32.astype(f64)
                # the averaged candidate is not tracked inside the
                # sprint; accumulate the chunk result once (dj=1) and
                # never adopt the average in sprint chunks
                return finish(u, v, s.u_sum + u, s.v_sum + v,
                              jnp.asarray(1, jnp.int32), t_done,
                              q32.astype(dtype),
                              jnp.zeros((), bool))

            if sprint and mu_stop >= sprint_mu_switch:
                # phase-1 mode (mu never drops below the switch inside
                # this program): pure sprint, no dual path -- under vmap
                # a lax.cond would compute BOTH branches for diverged
                # lanes, doubling the chunk cost
                return sprint_chunk(s)
            if sprint:
                return jax.lax.cond(mu > sprint_mu_switch,
                                    sprint_chunk, steps_chunk, s)
            return steps_chunk(s)

        # seed the stage average from the outer carry: nonzero after a
        # cap-exit (same stage, new anchor), zero at a true stage start
        init = IC(u=carry.u, v=carry.v, u_sum=carry.u_sum,
                  v_sum=carry.v_sum,
                  avg_crit=jnp.zeros((), bool),
                  j=jnp.zeros((), jnp.int32),
                  k=carry.k, qres=jnp.full((), jnp.inf, dtype),
                  status=jnp.zeros((), jnp.int32), res=carry.res)
        return (jax.lax.while_loop(cond, body_chunk if chunked else body,
                                   init), mv, rmv)

    def outer_body(carry: C):
        s, mv, rmv = inner(carry)
        # adopt the averaged iterate when it is the better candidate
        # (`abip.c:2125-2129`)
        dom = jnp.maximum(carry.sj + s.j, 1).astype(s.u.dtype)
        u_sel = jnp.where(s.avg_crit, s.u_sum / dom, s.u)
        v_sel = jnp.where(s.avg_crit, s.v_sum / dom, s.v)
        r = residuals(u_sel, v_sel, matvec64, rmatvec64)
        status = jnp.where(
            s.status != 0,
            s.status,
            hsd.lp_converged_code(r, eps, False, (carry.i > 0) & (s.k > 0)),
        )
        final_check = carry.final_check | (carry.mu < eps)
        mu = hsd.mu_update_hybrid(carry.mu, u_sel, v_sel, m, eps,
                                  hybrid_thresh, dynamic_x, dynamic_eta,
                                  shrink_second)
        u, v = hsd.reinit_rebalance(u_sel, v_sel, sigma0, m)
        # freeze the iterate once finished so vmapped lanes idle cleanly
        done = status != 0
        # anchor-cap exit (inner criterion unmet): continue the stage
        # from the raw iterate with mu and the stage counter unchanged
        cap_exit = (s.qres >= gamma0 * carry.mu) & (status == 0)
        u = jnp.where(done, u_sel, jnp.where(cap_exit, s.u, u))
        v = jnp.where(done, v_sel, jnp.where(cap_exit, s.v, v))
        mu = jnp.where(done | cap_exit, carry.mu, mu)
        di = jnp.where(cap_exit, 0, 1).astype(carry.i.dtype)
        # cap-exit: the stage continues under a fresh anchor, so the
        # stage-average accumulators survive; a true stage end resets
        # them (see the C docstring for the stall this prevents)
        u_sum = jnp.where(cap_exit, s.u_sum, 0.0)
        v_sum = jnp.where(cap_exit, s.v_sum, 0.0)
        sj = jnp.where(cap_exit, carry.sj + s.j, 0).astype(carry.sj.dtype)
        return C(u=u, v=v, mu=mu, i=carry.i + di, k=s.k,
                 final_check=final_check, status=status, res=r,
                 u_sum=u_sum, v_sum=v_sum, sj=sj)

    def outer_cond(carry: C):
        alive = (carry.status == 0) & (carry.i < max_ipm) & (
            carry.k < kcap)
        if mu_stop > 0.0:
            # phase-boundary exit: stop (status 0, state returned in
            # u_raw/v_raw/mu) once the barrier passes mu_stop, so a
            # second program can continue with a different engine
            alive = alive & (carry.mu >= mu_stop)
        return alive

    z0l = jnp.zeros((l,), dtype)
    sj0 = jnp.zeros((), jnp.int32)
    if init_state is None:
        init = C(u=u0, v=u0, mu=jnp.ones((), dtype),
                 i=jnp.zeros((), jnp.int32), k=jnp.zeros((), jnp.int32),
                 final_check=jnp.zeros((), bool),
                 status=jnp.zeros((), jnp.int32),
                 res=hsd.LPResiduals.init(dtype),
                 u_sum=z0l, v_sum=z0l, sj=sj0)
    else:
        if len(init_state) == 6:
            # legacy phase hand-off at a stage boundary (accumulators
            # are zero there by construction)
            u_i, v_i, mu_i, k_i, i_i, st_i = init_state
            us_i, vs_i, sj_i = z0l, z0l, sj0
        else:
            # mid-stage resume (compacted phase-2 rounds): the stage
            # average MUST survive the hand-off or the avg-criterion
            # restarts and stragglers blow up (see the C docstring)
            u_i, v_i, mu_i, k_i, i_i, st_i, us_i, vs_i, sj_i = init_state
            us_i = us_i.astype(dtype)
            vs_i = vs_i.astype(dtype)
            sj_i = sj_i.astype(jnp.int32)
        mu_i = mu_i.astype(dtype)
        init = C(u=u_i.astype(dtype), v=v_i.astype(dtype), mu=mu_i,
                 i=i_i.astype(jnp.int32), k=k_i.astype(jnp.int32),
                 final_check=mu_i < eps,
                 status=st_i.astype(jnp.int32),
                 res=hsd.LPResiduals.init(dtype),
                 u_sum=us_i, v_sum=vs_i, sj=sj_i)
    fin = jax.lax.while_loop(outer_cond, outer_body, init)

    # -- extract + un-normalize (`get_solution`, `abip.c:1344-1414`) --------
    r = fin.res
    tau = jnp.maximum(r.tau, hsd.EPS_TOL)
    x = fin.u[m : m + n] / tau / (E * sc_b)
    y = fin.u[:m] / tau / (D * sc_c)
    s_ = fin.v[m : m + n] / tau * E / (sc_c * scale)
    return DeviceSolveResult(
        x=x, y=y, s=s_, status=fin.status,
        ipm_iters=fin.i, admm_iters=fin.k,
        res_pri=r.res_pri, res_dual=r.res_dual, rel_gap=r.rel_gap,
        pobj=r.ct_x_by_tau / tau, dobj=r.bt_y_by_tau / tau,
        u_raw=fin.u, v_raw=fin.v, mu=fin.mu,
        u_sum_raw=fin.u_sum, v_sum_raw=fin.v_sum, sj=fin.sj,
    )


def pad_instances(problems, dtype=jnp.float64):
    """Pad a list of (A, b, c) with mixed shapes to common (M, N) stacks.

    Padding preserves solutions: extra rows are 0 = 0 (harmless under the
    rho_y-regularized normal equations) and extra columns get zero A
    columns with cost +1, so their optimal value is 0.  This is the padded
    suite-batching of SURVEY.md section 5.7 ("batching ~100 Netlib
    instances via vmap/stacked padding").

    Returns (As, bs, cs, dims) with dims the original (m, n) per instance.
    """
    import numpy as np

    M = max(A.shape[0] for A, _, _ in problems)
    N = max(A.shape[1] for A, _, _ in problems)
    B = len(problems)
    As = np.zeros((B, M, N))
    bs = np.zeros((B, M))
    cs = np.ones((B, N))      # padded columns cost +1 -> forced to zero
    dims = []
    for i, (A, b, c) in enumerate(problems):
        m, n = A.shape
        A = np.asarray(A.toarray() if hasattr(A, "toarray") else A, float)
        As[i, :m, :n] = A
        bs[i, :m] = b
        cs[i, :n] = c
        dims.append((m, n))
    return jnp.asarray(As, dtype), jnp.asarray(bs, dtype), jnp.asarray(cs, dtype), dims


def solve_lp_suite(problems, mesh=None, **kw):
    """Solve a heterogeneous list of (A, b, c) LPs as ONE vmapped program.

    Returns a list of per-instance dicts with the unpadded solutions.
    """
    import numpy as np

    As, bs, cs, dims = pad_instances(problems)
    res = solve_lp_batch(As, bs, cs, mesh=mesh, **kw)
    out = []
    for i, (m, n) in enumerate(dims):
        out.append({
            "x": np.asarray(res.x[i][:n]),
            "y": np.asarray(res.y[i][:m]),
            "s": np.asarray(res.s[i][:n]),
            "status": int(res.status[i]),
            "pobj": float(res.pobj[i]),
            "dobj": float(res.dobj[i]),
            "admm_iters": int(res.admm_iters[i]),
            "res_pri": float(res.res_pri[i]),
            "rel_gap": float(res.rel_gap[i]),
        })
    return out


def _opts_key(kw):
    return tuple(sorted(kw.items()))


@_lru_cache(maxsize=128)
def _vmapped_solver(opts_key):
    """Cached traced callable: re-creating `jax.vmap(lambda ...)` per
    call re-TRACES the whole ~1000-op program on every bench round
    (~3 s of host work per call at B=16 -- the dominant term of the r04
    honest wall once the delta engine cut device time to ~1 s)."""
    opts = dict(opts_key)
    return jax.jit(jax.vmap(
        lambda A, b, c: device_solve_lp(A, b, c, **opts)))


@_lru_cache(maxsize=128)
def _vmapped_resume_solver(opts_key):
    """Cached phase-2/resume variant (9-tuple init_state + traced cap).

    The cap is a SHARED SCALAR broadcast over lanes (vmap in_axes=None),
    as on the conic path (`batched_qcp._solve_qcp_batch_jit`)."""
    opts = dict(opts_key)
    return jax.jit(jax.vmap(
        lambda A, b, c, u0, v0, mu0, k0, i0, st0, us0, vs0, sj0, kc:
        device_solve_lp(
            A, b, c,
            init_state=(u0, v0, mu0, k0, i0, st0, us0, vs0, sj0),
            k_cap=kc, **opts),
        in_axes=(0,) * 12 + (None,)))


def solve_lp_batch(As, bs, cs, mesh=None, **kw) -> DeviceSolveResult:
    """Solve a stacked batch of same-shape LPs, one XLA program.

    As: (B, m, n); bs: (B, m); cs: (B, n).  With `mesh` given (a 1-D
    `jax.sharding.Mesh` over axis 'batch'), instances shard across devices.

    With a mesh the solve is a `shard_map` over 'batch': each device
    solves its own lanes (B must be a multiple of the mesh size).

    Defaults to cadence="chunk": under vmap, cond-gated check cadence
    degrades to compute-both-branches (the f64 residual check ran every
    iteration).  Pass cadence="cond" to override.

    engine="sprint2" runs TWO programs: phase 1 drives every lane with
    the stopping f32 sprint (in-loop inner stop) until its barrier passes
    `sprint_mu_switch`; phase 2 continues unfinished lanes with the
    anchored-f64 steps engine to the accuracy endgame.  The phase split
    keeps each program branch-free (a per-lane mu switch under vmap
    computes BOTH engines for diverged lanes), and pure-f32 iterations
    below mu ~1e-5 cannot converge at eps=1e-6 anyway (fuzz-measured:
    0/20 at switch 1e-7 vs 20/20 at 1e-5).
    """
    kw.setdefault("cadence", "chunk")
    # batch TILING: larger lockstep batches add straggler spread and
    # per-chunk anchor/residual work for finished lanes, so batches
    # above `tile` run as back-to-back tiles of `tile` lanes and no new
    # program shapes compile.  tile=0 disables (one whole-batch
    # program).  The default of 16 was tuned on an earlier accelerator
    # (ROADMAP Speed item 5 re-tunes it).
    tile = kw.pop("tile", 16)
    B = As.shape[0]
    if mesh is None and tile and B > tile and B % tile == 0:
        outs = [solve_lp_batch(As[i:i + tile], bs[i:i + tile],
                               cs[i:i + tile], mesh=None, tile=tile, **kw)
                for i in range(0, B, tile)]
        return DeviceSolveResult(*[
            None if outs[0][f] is None else
            jnp.concatenate([o[f] for o in outs])
            for f in range(len(outs[0]))])
    if kw.get("engine") == "sprint2":
        return _solve_lp_batch_twophase(As, bs, cs, mesh=mesh, **kw)
    kw.pop("endgame", None)   # sprint2-only knob
    fn = _vmapped_solver(_opts_key(kw))
    if mesh is not None:
        fn = _sharded_solver(fn, mesh)
    return fn(As, bs, cs)


def _sharded_solver(fn, mesh):
    """`fn` on each device's own lanes: lanes are independent, so the
    solve is a `shard_map` over the mesh's 'batch' axis with no
    collectives, and each device runs its lanes' kernels locally."""
    from jax.sharding import PartitionSpec as P

    spec = P("batch")
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(spec,) * 3,
                                 out_specs=spec, check_vma=False))


def _bucket(size):
    """Next power of two >= size (floor 4): the compacted phase-2 rounds
    quantize their batch shape so the whole descent B -> B/2 -> ... -> 4
    costs at most log2(B) distinct compiled programs."""
    b = 4
    while b < size:
        b *= 2
    return b


def _solve_lp_batch_twophase(As, bs, cs, mesh=None, **kw) -> DeviceSolveResult:
    """sprint2: phase-1 stopping-sprint bulk + phase-2 anchored endgame
    with straggler COMPACTION.

    Phase 1 drives all lanes with the stopping sprint to the mu switch.
    Phase 2 is the B-scaling hazard: one vmapped while_loop runs its
    body for EVERY lane until the slowest lane finishes, so whole-batch
    phase 2 costs B x (slowest lane's iterations) of anchored-f64
    work.  Here phase 2 runs in
    capped ROUNDS of `compact_period` ADMM iterations (the cap is a
    traced operand, so rounds share one compiled program per batch
    shape); between rounds the unfinished lanes are host-compacted into
    the next power-of-two bucket.  The tail then costs
    ~sum_rounds(B_round x compact_period) instead of B x max-lane.

    The resume state carries the stage-average accumulators
    (u_sum/v_sum/sj): a mid-stage hand-off that reset them would
    restart the averaged-iterate criterion and re-create the 20x
    straggler blow-ups fixed in 650080d.
    """
    kw.pop("engine")
    switch = kw.pop("sprint_mu_switch", 1e-4)
    kw.pop("mu_stop", None)
    kw.pop("init_state", None)
    # endgame="delta" continues unfinished lanes with the anchored-delta
    # engine (f32 sprint speed at f64-quality accuracy,
    # `ops/admm_delta.py`) instead of the per-iteration anchored-f64
    # steps engine
    endgame = kw.pop("endgame", "steps")
    if endgame not in ("steps", "delta"):
        raise ValueError(f"endgame must be 'steps' or 'delta'; "
                         f"got {endgame!r}")
    # compact_period trades straggler tax against per-round dispatch
    # cost (every capped round is a separate device dispatch and host
    # round trip).  16384 lets typical lanes (2-6k phase-2 iterations
    # on the smoke class) finish in ONE round; only genuine tails pay
    # extra rounds, compacted to small buckets.
    compact_period = kw.pop("compact_period", 16384)
    kw1 = dict(kw, engine="sprint", sprint_mu_switch=switch,
               mu_stop=switch, precision=kw.get("precision", "mixed"))
    r1 = solve_lp_batch(As, bs, cs, mesh=mesh, **kw1)
    done1 = np.asarray(r1.status) != 0
    if done1.all():
        return r1
    kw2 = dict(kw, engine="delta" if endgame == "delta" else "steps")
    max_admm = kw.get("max_admm", 200_000)

    fn2 = _vmapped_resume_solver(_opts_key(kw2))

    if mesh is not None or As.shape[0] <= 32:
        # whole-batch phase 2 in ONE device call: sharded batches must
        # (compaction would fight the fixed per-device lane assignment),
        # and small batches should -- the compaction loop costs ~15
        # blocking host<->device round trips, more than the straggler
        # tax it saves at B<=32 now that 650080d bounds the tails
        r2 = fn2(As, bs, cs, r1.u_raw, r1.v_raw, r1.mu, r1.admm_iters,
                 r1.ipm_iters, r1.status, r1.u_sum_raw, r1.v_sum_raw,
                 r1.sj, jnp.asarray(max_admm, jnp.int32))
        d = jnp.asarray(done1)

        def pick(a1, a2):
            if a1 is None:
                return a2
            return jnp.where(d.reshape(d.shape + (1,) * (a1.ndim - 1)),
                             a1, a2)

        return DeviceSolveResult(*[pick(a1, a2) for a1, a2 in zip(r1, r2)])

    As_n, bs_n, cs_n = jax.device_get((As, bs, cs))
    # ONE bulk device->host fetch instead of a round trip per field
    out = [np.array(f) for f in jax.device_get(r1)]  # scatter targets

    def _resume_state(r):
        return (r.u_raw, r.v_raw, r.mu, r.admm_iters, r.ipm_iters,
                r.status, r.u_sum_raw, r.v_sum_raw, r.sj)

    state = [np.array(t) for t in jax.device_get(_resume_state(r1))]
    _K = 3                                        # admm_iters slot
    _I = 4                                        # ipm_iters slot
    max_ipm = kw.get("max_ipm", 200)
    active = np.where(~done1)[0]
    while active.size:
        nb = _bucket(active.size)
        # pad the bucket with copies of active lanes (content is
        # irrelevant for cost: every lane pays every trip under vmap)
        idx = active[np.arange(nb) % active.size]
        # SHARED scalar cap (matches the conic compaction loop): every
        # active lane runs to the same total-iteration rung
        caps = np.int32(min(int(state[_K][active].max()) + compact_period,
                            max_admm))
        prev_k = state[_K][active].copy()
        prev_i = state[_I][active].copy()
        r2 = DeviceSolveResult(*jax.device_get(fn2(
            As_n[idx], bs_n[idx], cs_n[idx], *[s[idx] for s in state],
            caps)))
        live = np.arange(active.size)          # non-duplicate rows
        # a lane is finished when it converged, hit the ADMM cap, hit the
        # IPM cap (outer_cond exits with status 0 and admm_iters < cap --
        # without this the host loop re-runs it forever), or made no
        # progress at all this round (belt-and-braces against any other
        # status-0 exit)
        fin = ((r2.status[live] != 0)
               | (r2.admm_iters[live] >= max_admm)
               | (r2.ipm_iters[live] >= max_ipm)
               | ((r2.admm_iters[live] <= prev_k)
                  & (r2.ipm_iters[live] <= prev_i)))
        for f_out, f_new in zip(out, r2):
            f_out[active[fin]] = f_new[live][fin]
        keep = ~fin
        for s_arr, f_new in zip(state, _resume_state(r2)):
            s_arr[active[keep]] = np.asarray(f_new)[live][keep]
        active = active[keep]
    return DeviceSolveResult(*[jnp.asarray(f) for f in out])
