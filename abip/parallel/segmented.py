"""Segmented batched LP driver: init/solve split + streaming lane swap.

Why this exists: `solve_lp_batch` runs the vmapped nested while_loops
until the SLOWEST lane converges, so one straggler instance idles every
other lane, and the wall of one batch config varies by an order of
magnitude between instance draws.  The suite-throughput fix is
architectural: split the solver into

  * ``lp_setup(A, b, c)``      -- one instance's equilibration, b/c
    normalization, normal-matrix factorization, and HSD rank-1 data as a
    vmappable pytree (the reference's ``ABIP(init)`` / ``ABIP(solve)``
    split, `src/abip-lp/include/abip.h:116-123`, re-designed so a BATCH
    of independent instances shares one device program);
  * ``lp_segment(data, state)`` -- advance every lane by at most
    ``seg_chunks`` chunks of ``qres_period`` ADMM iterations (one device
    dispatch, bounded wall);
  * ``lp_extract(data, state)`` -- unscale + package solutions;

and let the host swap finished lanes' problem data for fresh instances
between segments (``solve_lp_stream``).  Lanes never idle while work
remains: the batch is a PIPELINE over the suite, the in-process analogue
of the reference's xargs batch runners (`scripts/bench-lp/run_all_abip.sh`)
with the whole suite resident on one chip.

The step math is `abip.hsd` (shared with every other driver); the
mixed-precision scheme is the anchored-delta design of
`parallel/batched.py`, with the anchor refreshed EVERY chunk (the
segmented loop is flat, so per-stage anchor bookkeeping would need
masked state; a fresh anchor each chunk is strictly more accurate and
costs one f64-quality pass per ``qres_period`` iterations).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import hsd
from ..scaling import equilibrate, normalize_bc
from ..settings import Settings

f32 = jnp.float32
f64 = jnp.float64

STATUS_IDLE = 99  # lane has no instance assigned (stream drained)


class LPLaneData(NamedTuple):
    """Per-instance immutable problem data (post-setup).  All leaves have
    instance-independent shapes for a fixed (m, n), so stacks vmap."""

    A_s: jnp.ndarray      # (m, n) equilibrated f64
    A32: jnp.ndarray      # f32 copy (anchored delta products)
    Ninv32: jnp.ndarray   # (m, m) f32 explicit (rho_y I + A A')^-1
    Ninv64: jnp.ndarray   # f64 explicit inverse (anchor passes)
    N64: jnp.ndarray      # (m, m) f64 normal matrix (iterative refinement)
    b_s: jnp.ndarray
    c_s: jnp.ndarray
    h: jnp.ndarray        # (m+n,) HSD rank-1 data (`abip.c:1917-1924`)
    g: jnp.ndarray
    g_th: jnp.ndarray
    pr_scale: jnp.ndarray
    dr_scale: jnp.ndarray
    obj_scale: jnp.ndarray
    nm_b0: jnp.ndarray
    nm_c0: jnp.ndarray
    D: jnp.ndarray
    E: jnp.ndarray
    sc_b: jnp.ndarray
    sc_c: jnp.ndarray


class LPLaneState(NamedTuple):
    """Mutable per-lane iterate state (the checkpointable pytree)."""

    u: jnp.ndarray
    v: jnp.ndarray
    u_sum: jnp.ndarray    # within-stage running sums (average candidate)
    v_sum: jnp.ndarray
    j: jnp.ndarray        # iterations into the current barrier stage
    k: jnp.ndarray        # total ADMM iterations
    i: jnp.ndarray        # barrier stages completed
    mu: jnp.ndarray
    final_check: jnp.ndarray
    avg_crit: jnp.ndarray
    status: jnp.ndarray
    res: hsd.LPResiduals


class StreamResult(NamedTuple):
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


@partial(jax.jit, static_argnames=("rho_y", "scale", "ruiz_iter"))
def lp_setup(A, b, c, rho_y=1e-3, scale=1.0, ruiz_iter=10):
    """One instance's init phase as a pytree (jit/vmap-able).

    Mirrors `device_solve_lp`'s setup block: pc+Ruiz equilibration, b/c
    normalization, cached normal-matrix factor (as explicit inverses:
    applying N^-1 is then ONE matmul under vmap), h/g/g_th."""
    A = A.astype(f64)
    b = b.astype(f64)
    c = c.astype(f64)
    m, n = A.shape

    nm_b0 = jnp.linalg.norm(b)
    nm_c0 = jnp.linalg.norm(c)
    stg = Settings(pc_ruiz_rescale=True, origin_rescale=False,
                   qp_rescale=False, ruiz_iter=ruiz_iter, scale=scale)
    A_s, scal = equilibrate(A, stg)
    b_s, c_s, sc_b, sc_c = normalize_bc(scal, b, c, scale)
    D, E = scal.D, scal.E

    N64 = rho_y * jnp.eye(m, dtype=f64) + A_s @ A_s.T
    chol64 = jax.lax.linalg.cholesky(N64)
    Ninv64 = jax.scipy.linalg.cho_solve((chol64, True),
                                        jnp.eye(m, dtype=f64))
    h = jnp.concatenate([-b_s, c_s])
    g_y = Ninv64 @ (h[:m] + A_s @ h[m:])
    g_x = A_s.T @ g_y - h[m:]
    g = jnp.concatenate([g_y, -g_x])
    return LPLaneData(
        A_s=A_s, A32=A_s.astype(f32), Ninv32=Ninv64.astype(f32),
        Ninv64=Ninv64, N64=N64, b_s=b_s, c_s=c_s, h=h, g=g,
        g_th=jnp.dot(h, g),
        pr_scale=D / (sc_b * scale), dr_scale=E / (sc_c * scale),
        obj_scale=scale * sc_c * sc_b, nm_b0=nm_b0, nm_c0=nm_c0,
        D=D, E=E, sc_b=sc_b, sc_c=sc_c,
    )


def lp_init_state(m, n) -> LPLaneState:
    """Cold-start state (`update_work` cold start, `abip.c:1843-1927`)."""
    l = m + n + 1
    u0 = jnp.concatenate([jnp.zeros((m,), f64), jnp.ones((l - m,), f64)])
    z = jnp.zeros((l,), f64)
    return LPLaneState(
        u=u0, v=u0, u_sum=z, v_sum=z,
        j=jnp.zeros((), jnp.int32), k=jnp.zeros((), jnp.int32),
        i=jnp.zeros((), jnp.int32), mu=jnp.ones((), f64),
        final_check=jnp.zeros((), bool), avg_crit=jnp.zeros((), bool),
        status=jnp.zeros((), jnp.int32), res=hsd.LPResiduals.init(f64),
    )


def _lane_segment(d: LPLaneData, s: LPLaneState, *, seg_chunks, qres_period,
                  eps, max_ipm, max_admm, alpha, rho_y, ir_steps,
                  hybrid_thresh, dynamic_x, dynamic_eta, shrink_second,
                  gamma0, sigma0):
    """Advance ONE lane by at most seg_chunks chunks (pure function)."""
    m = d.A_s.shape[0]
    n = d.A_s.shape[1]
    l = m + n + 1

    matvec64 = lambda x: d.A_s @ x
    rmatvec64 = lambda y: d.A_s.T @ y

    def rank1_correct(u, v):
        r = u + v
        q = jnp.concatenate([rho_y * r[:m], r[m : m + n]])
        q = q - r[l - 1] * d.h
        q = q - (jnp.dot(q, d.g) / (d.g_th + 1.0)) * d.h
        return q, r[l - 1]

    def make_anchor(u, v):
        """f64-quality anchor pass (refreshed every chunk)."""
        x0 = u[m : m + n]
        y0 = u[:m]
        q, _ = rank1_correct(u, v)
        w0 = -q[m:]
        Aw0 = d.A_s @ w0
        q0 = q[:m] + Aw0
        z0 = d.Ninv64 @ q0
        return (x0, y0, d.A_s @ x0, d.A_s.T @ y0, w0, Aw0, z0,
                d.A_s.T @ z0, q0)

    def residuals(u, v):
        return hsd.lp_residuals(u, v, matvec64, rmatvec64, d.b_s, d.c_s,
                                d.pr_scale, d.dr_scale, d.obj_scale,
                                d.nm_b0, d.nm_c0, m, n)

    def body(carry):
        t, s = carry
        anc = make_anchor(s.u, s.v)
        x0, y0, Ax0, ATy0, w0, Aw0, z0, ATz0, q0 = anc

        def amv(x):
            return Ax0 + (d.A32 @ (x - x0).astype(f32)).astype(f64)

        def armv(y):
            return ATy0 + (d.A32.T @ (y - y0).astype(f32)).astype(f64)

        def project(u, v):
            q, r_tau = rank1_correct(u, v)
            wx = -q[m:]
            rhs = q[:m] + Aw0 + (d.A32 @ (wx - w0).astype(f32)).astype(f64)
            dz = (d.Ninv32 @ (rhs - q0).astype(f32)).astype(f64)
            z_y = z0 + dz
            for _ in range(ir_steps):
                resid = rhs - d.N64 @ z_y
                z_y = z_y + (d.Ninv32 @ resid.astype(f32)).astype(f64)
            z_x = ATz0 + (d.A32.T @ (z_y - z0).astype(f32)).astype(f64) - wx
            z = jnp.concatenate([z_y, z_x])
            tau_t = r_tau + jnp.dot(z, d.h)
            return jnp.concatenate([z, tau_t[None]])

        def qres_of(u, v):
            return hsd.q_norm_resd(u, v, amv, armv, d.b_s, d.c_s, m, n)

        def lean(_, t4):
            u, v, us, vs = t4
            u_t = project(u, v)
            u, v = hsd.admm_update(u, v, u, u_t, s.mu, alpha, m)
            return (u, v, us + u, vs + v)

        u, v, u_sum, v_sum = jax.lax.fori_loop(
            0, qres_period, lean, (s.u, s.v, s.u_sum, s.v_sum))
        j = s.j + qres_period
        k = s.k + qres_period

        dom = jnp.maximum(j.astype(f64), 1.0)
        q_cur = qres_of(u, v)
        u_avg = u_sum / dom
        v_avg = v_sum / dom
        q_avg = qres_of(u_avg, v_avg)
        avg_crit = q_avg < q_cur
        qres = jnp.where(avg_crit, q_avg, q_cur)

        u_sel = jnp.where(avg_crit, u_avg, u)
        v_sel = jnp.where(avg_crit, v_avg, v)
        # TRUE f64 residual check, once per chunk (see batched.py's
        # cadence notes on why never the anchored f32 products)
        r = residuals(u_sel, v_sel)
        stage_exit = qres < gamma0 * s.mu
        st = jnp.where(
            s.final_check | stage_exit,
            hsd.lp_converged_code(r, eps, False, (s.i > 0) & (k > 0)),
            0,
        ).astype(jnp.int32)
        done = st != 0

        # stage transition (`outer_body` logic): mu update + rebalance
        final_check = s.final_check | (stage_exit & (s.mu < eps))
        mu_new = hsd.mu_update_hybrid(s.mu, u_sel, v_sel, m, eps,
                                      hybrid_thresh, dynamic_x,
                                      dynamic_eta, shrink_second)
        u_re, v_re = hsd.reinit_rebalance(u_sel, v_sel, sigma0, m)
        adv = stage_exit & ~done
        z = jnp.zeros((l,), f64)
        new = LPLaneState(
            u=jnp.where(done, u_sel, jnp.where(adv, u_re, u)),
            v=jnp.where(done, v_sel, jnp.where(adv, v_re, v)),
            u_sum=jnp.where(adv, z, u_sum),
            v_sum=jnp.where(adv, z, v_sum),
            j=jnp.where(adv, 0, j),
            k=k,
            i=s.i + jnp.where(adv, 1, 0).astype(s.i.dtype),
            mu=jnp.where(adv, mu_new, s.mu),
            final_check=final_check,
            avg_crit=avg_crit,
            status=st,
            res=r,
        )
        return (t + 1, new)

    def cond(carry):
        t, s = carry
        return ((t < seg_chunks) & (s.status == 0)
                & (s.k < max_admm) & (s.i < max_ipm))

    _, out = jax.lax.while_loop(cond, body, (jnp.zeros((), jnp.int32), s))
    return out


def make_segment_fn(*, seg_chunks=32, qres_period=64, eps=1e-6, max_ipm=200,
                    max_admm=200_000, alpha=1.8, rho_y=1e-3, ir_steps=1,
                    hybrid_thresh=1000.0, dynamic_x=0.8, dynamic_eta=1.1,
                    shrink_second=0.5, gamma0=2.0, sigma0=0.3):
    """Jitted (data, state) -> state advancing every lane one segment."""
    fn = partial(_lane_segment, seg_chunks=seg_chunks,
                 qres_period=qres_period, eps=eps, max_ipm=max_ipm,
                 max_admm=max_admm, alpha=alpha, rho_y=rho_y,
                 ir_steps=ir_steps, hybrid_thresh=hybrid_thresh,
                 dynamic_x=dynamic_x, dynamic_eta=dynamic_eta,
                 shrink_second=shrink_second, gamma0=gamma0, sigma0=sigma0)
    return jax.jit(jax.vmap(fn))


@jax.jit
def lp_extract(d: LPLaneData, s: LPLaneState) -> StreamResult:
    """Unscale + package one lane stack (`get_solution`, `abip.c:1344-1414`)."""
    def one(d, s):
        m = d.A_s.shape[0]
        n = d.A_s.shape[1]
        r = s.res
        tau = jnp.maximum(r.tau, hsd.EPS_TOL)
        scale = 1.0  # lp_setup fixes scale=1 (the bench/stream config)
        return StreamResult(
            x=s.u[m : m + n] / tau / (d.E * d.sc_b),
            y=s.u[:m] / tau / (d.D * d.sc_c),
            s=s.v[m : m + n] / tau * d.E / (d.sc_c * scale),
            status=s.status, ipm_iters=s.i, admm_iters=s.k,
            res_pri=r.res_pri, res_dual=r.res_dual, rel_gap=r.rel_gap,
            pobj=r.ct_x_by_tau / tau, dobj=r.bt_y_by_tau / tau,
        )

    return jax.vmap(one)(d, s)


@jax.jit
def _splice(stack, lane, new):
    """stack[lane] = new across a pytree (one fused device op)."""
    return jax.tree.map(lambda s, x: s.at[lane].set(x), stack, new)


def solve_lp_stream(problems, B=8, seg_chunks=32, rho_y=1e-3, **kw):
    """Stream a suite of same-shape LPs through B pipelined lanes.

    problems: list of (A, b, c) with a common (m, n).  Returns (results,
    info): per-instance dicts in input order, and aggregate stats.  A
    finished lane is refilled with the next pending instance after the
    segment in which it finished -- no lane idles while work remains, so
    stragglers cost only their own lane's time (unlike `solve_lp_batch`,
    where the whole batch waits for the slowest instance).
    """
    import numpy as np

    if not problems:
        return [], {}
    m, n = problems[0][0].shape
    for A, _, _ in problems:
        if A.shape != (m, n):
            raise ValueError("solve_lp_stream needs same-shape instances; "
                             f"got {A.shape} vs {(m, n)}")
    N = len(problems)
    B = min(B, N)
    eps = kw.get("eps", 1e-6)
    segment = make_segment_fn(seg_chunks=seg_chunks, rho_y=rho_y, **kw)
    setup = jax.jit(partial(lp_setup, rho_y=rho_y))

    def setup_np(i):
        A, b, c = problems[i]
        return setup(jnp.asarray(A, f64), jnp.asarray(b, f64),
                     jnp.asarray(c, f64))

    data = jax.tree.map(lambda *xs: jnp.stack(xs),
                        *[setup_np(i) for i in range(B)])
    state0 = lp_init_state(m, n)
    state = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape),
                         state0)
    lane_inst = list(range(B))
    next_idx = B
    results = [None] * N
    segments = 0

    while True:
        state = segment(data, state)
        segments += 1
        st = np.asarray(state.status)
        k = np.asarray(state.k)
        i = np.asarray(state.i)
        max_admm = kw.get("max_admm", 200_000)
        max_ipm = kw.get("max_ipm", 200)
        finished = [ln for ln in range(B)
                    if lane_inst[ln] is not None
                    and (st[ln] != 0 or k[ln] >= max_admm
                         or i[ln] >= max_ipm)]
        if finished:
            out = lp_extract(data, state)
            for ln in finished:
                idx = lane_inst[ln]
                results[idx] = {
                    "x": np.asarray(out.x[ln]), "y": np.asarray(out.y[ln]),
                    "s": np.asarray(out.s[ln]),
                    "status": int(st[ln]), "admm_iters": int(k[ln]),
                    "ipm_iters": int(i[ln]),
                    "pobj": float(out.pobj[ln]),
                    "dobj": float(out.dobj[ln]),
                    "res_pri": float(out.res_pri[ln]),
                    "rel_gap": float(out.rel_gap[ln]),
                }
                if next_idx < N:
                    data = _splice(data, ln, setup_np(next_idx))
                    state = _splice(state, ln, state0)
                    lane_inst[ln] = next_idx
                    next_idx += 1
                else:
                    # park the lane: nonzero status freezes it in-segment
                    state = _splice(
                        state, ln,
                        state0._replace(
                            status=jnp.asarray(STATUS_IDLE, jnp.int32)))
                    lane_inst[ln] = None
        if all(r is not None for r in results):
            break
    info = {"segments": segments, "B": B, "seg_chunks": seg_chunks,
            "eps": eps,
            "total_admm_iters": int(sum(r["admm_iters"] for r in results)),
            "solved": int(sum(r["status"] == 1 for r in results))}
    return results, info
