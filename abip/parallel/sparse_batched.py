"""Batched SAME-PATTERN sparse LP entirely on device: COO SpMV + PCG.

The reference's large-sparse regime (PageRank LPs from graph matrices,
`/root/reference/scripts/README.md:38-39`) runs the indirect backend:
matrix-free PCG on the normal equations with a Jacobi preconditioner
and a decaying tolerance (`/root/reference/src/abip-lp/linsys/
indirect.c:321-434`).  Driving ONE instance through the host driver
leaves nothing to amortize the per-stage dispatch and host syncs
against (19 barrier stages x ~5 iterations).

This driver removes both bottlenecks:

  * the WHOLE solve (outer barrier ladder + inner ADMM + CG) is one
    jitted program -- zero host round-trips until the result fetch;
  * a FAMILY of same-pattern instances (shared COO structure, per-lane
    values -- graph suites are exactly this shape) is vmapped into one
    program, so the chip amortizes across B lanes at once.

SpMV is COO gather + segment-sum (for deg-c random patterns the
gathered operand is O(nnz), ~100x smaller than dense-tile BCSR
gathers at these densities); the CG solve reuses `linsys.cg.pcg` with
the reference tolerance ladder.  Math is the same `hsd.*` module the
dense drivers compose -- algorithm code lives once.

Reference hot path: `abip.c:2056-2297` (driver), `indirect.c:321-434`
(PCG backend).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import hsd
from ..linsys.cg import CG_BEST_TOL, cg_tolerance, pcg
from .batched import DeviceSolveResult

f64 = jnp.float64


def coo_matvec(rows, cols, vals, x, m):
    """y = A x over COO triplets (rows sorted ascending)."""
    return jax.ops.segment_sum(vals * x[cols], rows, m,
                               indices_are_sorted=True)


def coo_rmatvec(rows, cols, vals, y, n):
    """x = A' y over the same triplets (cols unsorted)."""
    return jax.ops.segment_sum(vals * y[rows], cols, n)


def _equilibrate_coo(rows, cols, vals, m, n, iters=10):
    """Ruiz equilibration on COO values (`_normalize_A`,
    `common.c:150-565`, sparse form): iterated sqrt-inf-norm row/col
    scaling via segment-max, plus the mean row/col L2 norms that feed
    b/c normalization (`normalize.c:11-40`).  All on device -- the
    dense pipeline's full-matrix passes become O(nnz) segment ops."""
    dtype = vals.dtype
    D = jnp.ones((m,), dtype)
    E = jnp.ones((n,), dtype)

    def body(_, t):
        vals, D, E = t
        av = jnp.abs(vals)
        r = jax.ops.segment_max(av, rows, m, indices_are_sorted=True)
        cmax = jax.ops.segment_max(av, cols, n)
        dr = 1.0 / jnp.sqrt(jnp.maximum(r, 1e-12))
        dc = 1.0 / jnp.sqrt(jnp.maximum(cmax, 1e-12))
        vals = vals * dr[rows] * dc[cols]
        return (vals, D * dr, E * dc)

    vals, D, E = jax.lax.fori_loop(0, iters, body, (vals, D, E))
    row_l2 = jnp.sqrt(jax.ops.segment_sum(vals * vals, rows, m,
                                          indices_are_sorted=True))
    col_l2 = jnp.sqrt(jax.ops.segment_sum(vals * vals, cols, n))
    # return DIVISORS (A_s = A / (D E)), the dense pipeline's ScalingData
    # convention (`scaling.equilibrate`), so b/c normalization and the
    # unscale formulas are shared verbatim
    return vals, 1.0 / D, 1.0 / E, jnp.mean(row_l2), jnp.mean(col_l2)


def _device_solve_lp_coo(rows, cols, vals, b, c, *, m, n, eps, max_ipm,
                         max_admm, alpha, rho_y, gamma0, sigma0,
                         hybrid_thresh, dynamic_x, dynamic_eta,
                         shrink_second, cg_rate, cg_max_iters,
                         qres_period, probe_period):
    """One sparse LP on device (vmap-able over vals/b/c; rows/cols are
    SHARED pattern operands).  f64 steps engine, chunk cadence -- the
    structure of `batched.device_solve_lp`'s f64 path with the cached
    dense factor replaced by warm-started PCG."""
    dtype = f64
    l = m + n + 1
    b = b.astype(dtype)
    c = c.astype(dtype)
    vals = vals.astype(dtype)

    nm_b0 = jnp.linalg.norm(b)
    nm_c0 = jnp.linalg.norm(c)
    # sparse equilibration + b/c normalization (`normalize.c:11-40`):
    # graph LPs carry b ~ (1-alpha)/n 1 whose tiny norm otherwise
    # degenerates tau (measured: NaN pobj, 200 stages unconverged)
    vals, D, E, mnr, mnc = _equilibrate_coo(rows, cols, vals, m, n)
    c_s = c / E
    sc_c = mnr / jnp.maximum(jnp.linalg.norm(c_s), 1e-3)
    b_s = b / D
    sc_b = mnc / jnp.maximum(jnp.linalg.norm(b_s), 1e-3)
    b = b_s * sc_b
    c = c_s * sc_c

    def matvec(x):
        return coo_matvec(rows, cols, vals, x, m)

    def rmatvec(y):
        return coo_rmatvec(rows, cols, vals, y, n)

    ones_scale = sc_c * sc_b
    pr_scale = D / sc_b
    dr_scale = E / sc_c

    # normal-equations operator + Jacobi preconditioner
    # (`indirect.c:36-79`)
    diag_AAt = jax.ops.segment_sum(vals * vals, rows, m,
                                   indices_are_sorted=True)
    M_pre = 1.0 / (rho_y + diag_AAt)

    def G(y):
        return rho_y * y + matvec(rmatvec(y))

    def solve_fn(w_y, w_x, k, warm):
        rhs = w_y + matvec(w_x)
        tol = cg_tolerance(jnp.linalg.norm(rhs), k, cg_rate, dtype)
        z_y, its = pcg(G, M_pre, rhs, warm, tol, cg_max_iters)
        z_x = rmatvec(z_y) - w_x
        return z_y, z_x, its

    # h = (-b; c), g = K^-1 h at setup accuracy (`abip.c:1917-1924`)
    h = jnp.concatenate([-b, c])
    g_y, _ = pcg(G, M_pre, h[:m] + matvec(h[m:]), jnp.zeros((m,), dtype),
                 jnp.maximum(jnp.linalg.norm(h) * CG_BEST_TOL, 1e-12),
                 4 * cg_max_iters)
    g_x = rmatvec(g_y) - h[m:]
    # MINUS g_x: the tau-row correction's K has +I in the (2,2) block
    # (`update_work`, `abip.c:1917-1924`; same sign as the dense driver)
    g = jnp.concatenate([g_y, -g_x])
    g_th = jnp.dot(h, g)

    def residuals(u, v):
        return hsd.lp_residuals(u, v, matvec, rmatvec, b, c, pr_scale,
                                dr_scale, ones_scale, nm_b0, nm_c0, m, n)

    def qres_of(u, v):
        return hsd.q_norm_resd(u, v, matvec, rmatvec, b, c, m, n)

    u0 = jnp.concatenate([jnp.zeros((m,), dtype),
                          jnp.ones((l - m,), dtype)])

    class C(NamedTuple):
        u: jnp.ndarray
        v: jnp.ndarray
        mu: jnp.ndarray
        i: jnp.ndarray
        k: jnp.ndarray
        final_check: jnp.ndarray
        status: jnp.ndarray
        res: hsd.LPResiduals

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

    probe = min(probe_period, qres_period)

    def inner(carry: C):
        mu = carry.mu

        def cond(s: IC):
            return ((s.qres >= gamma0 * mu) & (s.status == 0)
                    & (s.k < max_admm))

        def body_chunk(s: IC):
            def lean(_, t):
                u, v, us, vs = t
                u_t, _ = hsd.project_lin_sys(u, v, h, g, g_th, rho_y,
                                             solve_fn, s.k, m, n)
                u, v = hsd.admm_update(u, v, u, u_t, mu, alpha, m)
                return (u, v, us + u, vs + v)

            def micro_cond(t):
                _u, _v, _us, _vs, dj, dk, q, _ac = t
                return ((q >= gamma0 * mu) & (dk < qres_period)
                        & (s.k + dk < max_admm))

            def micro_body(t):
                u, v, us, vs, dj, dk, _q, _ac = t
                u, v, us, vs = jax.lax.fori_loop(0, probe, lean,
                                                 (u, v, us, vs))
                dj = dj + probe
                dk = dk + probe
                dom = jnp.maximum((s.j + dj).astype(u.dtype), 1.0)
                q_cur = qres_of(u, v)
                q_avg = qres_of(us / dom, vs / dom)
                avg_crit = q_avg < q_cur
                q = jnp.where(avg_crit, q_avg, q_cur)
                return (u, v, us, vs, dj, dk, q, avg_crit)

            z32 = jnp.zeros((), jnp.int32)
            u, v, u_sum, v_sum, dj, dk, qres, avg_crit = \
                jax.lax.while_loop(
                    micro_cond, micro_body,
                    (s.u, s.v, s.u_sum, s.v_sum, z32, z32, s.qres,
                     s.avg_crit))
            dom = jnp.maximum((s.j + dj).astype(u.dtype), 1.0)
            u_sel = jnp.where(avg_crit, u_sum / dom, u)
            v_sel = jnp.where(avg_crit, v_sum / dom, v)
            r = residuals(u_sel, v_sel)
            st = jnp.where(
                carry.final_check,
                hsd.lp_converged_code(r, eps, False,
                                      (carry.i > 0) & (s.k + dk > 0)),
                0).astype(jnp.int32)
            return IC(u=u, v=v, u_sum=u_sum, v_sum=v_sum,
                      avg_crit=avg_crit, j=s.j + dj, k=s.k + dk,
                      qres=qres, status=st, res=r)

        z0l = jnp.zeros((l,), dtype)
        init = IC(u=carry.u, v=carry.v, u_sum=z0l, v_sum=z0l,
                  avg_crit=jnp.zeros((), bool),
                  j=jnp.zeros((), jnp.int32), k=carry.k,
                  qres=jnp.full((), jnp.inf, dtype),
                  status=jnp.zeros((), jnp.int32), res=carry.res)
        return jax.lax.while_loop(cond, body_chunk, init)

    def outer_body(carry: C):
        s = inner(carry)
        dom = jnp.maximum(s.j, 1).astype(s.u.dtype)
        u_sel = jnp.where(s.avg_crit, s.u_sum / dom, s.u)
        v_sel = jnp.where(s.avg_crit, s.v_sum / dom, s.v)
        r = residuals(u_sel, v_sel)
        status = jnp.where(
            s.status != 0, s.status,
            hsd.lp_converged_code(r, eps, False,
                                  (carry.i > 0) & (s.k > 0)))
        final_check = carry.final_check | (carry.mu < eps)
        mu = hsd.mu_update_hybrid(carry.mu, u_sel, v_sel, m, eps,
                                  hybrid_thresh, dynamic_x, dynamic_eta,
                                  shrink_second)
        u, v = hsd.reinit_rebalance(u_sel, v_sel, sigma0, m)
        done = status != 0
        u = jnp.where(done, u_sel, u)
        v = jnp.where(done, v_sel, v)
        mu = jnp.where(done, carry.mu, mu)
        return C(u=u, v=v, mu=mu, i=carry.i + 1, k=s.k,
                 final_check=final_check, status=status, res=r)

    def outer_cond(carry: C):
        return ((carry.status == 0) & (carry.i < max_ipm)
                & (carry.k < max_admm))

    init = C(u=u0, v=u0, mu=jnp.ones((), dtype),
             i=jnp.zeros((), jnp.int32), k=jnp.zeros((), jnp.int32),
             final_check=jnp.zeros((), bool),
             status=jnp.zeros((), jnp.int32),
             res=hsd.LPResiduals.init(dtype))
    fin = jax.lax.while_loop(outer_cond, outer_body, init)

    r = fin.res
    tau = jnp.maximum(r.tau, hsd.EPS_TOL)
    # un-normalize (`get_solution`, `abip.c:1344-1414`)
    return DeviceSolveResult(
        x=fin.u[m : m + n] / tau / (E * sc_b),
        y=fin.u[:m] / tau / (D * sc_c),
        s=fin.v[m : m + n] / tau * E / sc_c, status=fin.status,
        ipm_iters=fin.i, admm_iters=fin.k,
        res_pri=r.res_pri, res_dual=r.res_dual, rel_gap=r.rel_gap,
        pobj=r.ct_x_by_tau / tau, dobj=r.bt_y_by_tau / tau)


@partial(jax.jit, static_argnames=("m", "n", "eps", "max_ipm", "max_admm",
                                   "alpha", "rho_y", "gamma0", "sigma0",
                                   "hybrid_thresh", "dynamic_x",
                                   "dynamic_eta", "shrink_second",
                                   "cg_rate", "cg_max_iters",
                                   "qres_period", "probe_period"))
def solve_lp_batch_coo(rows, cols, valss, bs, cs, *, m, n, eps=1e-6,
                       max_ipm=200, max_admm=100_000, alpha=1.8,
                       rho_y=1e-3, gamma0=2.0, sigma0=0.3,
                       hybrid_thresh=1000.0, dynamic_x=0.8,
                       dynamic_eta=1.1, shrink_second=0.5, cg_rate=2.0,
                       cg_max_iters=500, qres_period=64,
                       probe_period=8) -> DeviceSolveResult:
    """Solve a stacked batch of SAME-PATTERN sparse LPs as one program.

    rows/cols: shared COO pattern (int32, rows sorted ascending);
    valss: (B, nnz) per-lane values; bs: (B, m); cs: (B, n).  Callers
    pre-scale (graph LPs arrive well-equilibrated); tolerances are
    relative residuals in the given units (`has_converged`,
    `abip.c:1613-1641`)."""
    rows = jnp.asarray(rows, jnp.int32)
    cols = jnp.asarray(cols, jnp.int32)

    def one(vals, b, c):
        return _device_solve_lp_coo(
            rows, cols, vals, b, c, m=m, n=n, eps=eps, max_ipm=max_ipm,
            max_admm=max_admm, alpha=alpha, rho_y=rho_y, gamma0=gamma0,
            sigma0=sigma0, hybrid_thresh=hybrid_thresh,
            dynamic_x=dynamic_x, dynamic_eta=dynamic_eta,
            shrink_second=shrink_second, cg_rate=cg_rate,
            cg_max_iters=cg_max_iters, qres_period=qres_period,
            probe_period=probe_period)

    return jax.vmap(one, in_axes=(0, 0, 0))(valss, bs, cs)
