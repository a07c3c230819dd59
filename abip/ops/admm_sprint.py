"""Fused ADMM sprint: T whole f32 LP iterations in one XLA loop.

The sprint engines of the LP batch driver (`engine="sprint"` /
`"sprint2"`, `parallel/batched.py`) run T complete f32 ADMM iterations
-- projection (rank-1 tau correction + fold + N^-1 apply + back-subst),
barrier prox, dual update -- inside one `fori_loop`, with an explicit
normal-matrix inverse so the KKT apply is one matvec.  HIGHEST-precision
f32 products throughout (true f32, never TF32).

f32 only: the inner engine of the anchored mixed-precision scheme --
sprint T f32 iterations, then re-anchor/correct in f64 outside (see
`parallel/batched.py` docstring).

Reference hot loop: `src/abip-lp/src/abip.c:2131-2215` (project_lin_sys
:539, project_barrier :717, update_dual_vars :567).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

_TINY = 1e-30


def _prox(t, lam):
    pos = 0.5 * (t + jnp.sqrt(t * t + 4.0 * lam))
    neg = 2.0 * lam / (-t * (1.0 + jnp.sqrt(1.0 + 4.0 * lam / (t * t + _TINY))) + _TINY)
    return jnp.where(t >= 0, pos, neg)


def _sprint_ref(A, Ninv, h, g, scalars, u, v, T, m):
    """Reference implementation (plain jnp) of the T-iteration sprint.

    Traced under default_matmul_precision('highest'): a reduced-
    precision f32 product (see _dot_t) diverges the trajectory."""
    with jax.default_matmul_precision("highest"):
        return _sprint_ref_inner(A, Ninv, h, g, scalars, u, v, T, m)


def _sprint_ref_inner(A, Ninv, h, g, scalars, u, v, T, m):
    rho_y, inv_gth1, lam, alpha = scalars
    n = A.shape[1]
    l = m + n + 1
    hv = h[: l - 1]
    gv = g[: l - 1]

    def body(_, carry):
        u, v = carry
        r = u + v
        q = jnp.concatenate([rho_y * r[:m], r[m : l - 1]])
        q = q - r[l - 1] * hv
        q = q - (jnp.dot(q, gv) * inv_gth1) * hv
        wx = -q[m:]
        rhs = q[:m] + A @ wx
        z_y = Ninv @ rhs
        z_x = A.T @ z_y - wx
        tau_t = r[l - 1] + jnp.dot(z_y, hv[:m]) + jnp.dot(z_x, hv[m:])
        u_t = jnp.concatenate([z_y, z_x, tau_t[None]])
        head = u_t[:m] - v[:m]
        t = alpha * u_t[m:] + (1 - alpha) * u[m:] - v[m:]
        tail = _prox(t, lam)
        u_new = jnp.concatenate([head, tail])
        v_new = v.at[m:].add(tail - alpha * u_t[m:] - (1 - alpha) * u[m:])
        return (u_new, v_new)

    return jax.lax.fori_loop(0, T, body, (u, v))


def _dot_t(a, M):
    """(1, k) x (r, k) -> (1, r): contract a's columns with M's rows.

    Precision.HIGHEST is load-bearing: a reduced-precision product (bf16
    or TF32, ~1e-3 relative error) destroys the cancellation-heavy tau_t
    dot and blows up the sprint trajectory."""
    return jax.lax.dot_general(a, M, (((1,), (1,)), ((), ())),
                               preferred_element_type=jnp.float32,
                               precision=jax.lax.Precision.HIGHEST)


def _dot(a, M):
    """(1, r) x (r, k) -> (1, k).  See _dot_t on Precision.HIGHEST."""
    return jax.lax.dot_general(a, M, (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.float32,
                               precision=jax.lax.Precision.HIGHEST)


def _sprint_stop_ref(A, Ninv, hy, hx, gy, gx, scalars, y, x, vy, vx,
                     T, probe):
    """The stopping sprint: true-f32 matmuls, probe-granular in-loop
    qres stop.  Vectors are (1, k) rows."""
    with jax.default_matmul_precision("highest"):
        rho_y, inv_gth1, lam, alpha, tau0, kappa0, thresh = scalars
        vy2 = jnp.sum(vy * vy)

        def iter_body(_, carry):
            y, x, vx, tau, kappa = carry
            ry = y + vy
            rx = x + vx
            rtau = tau + kappa
            qy = rho_y * ry - rtau * hy
            qx = rx - rtau * hx
            coef = (jnp.sum(qy * gy) + jnp.sum(qx * gx)) * inv_gth1
            qy = qy - coef * hy
            qx = qx - coef * hx
            wx = -qx
            rhs = qy + _dot_t(wx, A)
            z_y = _dot_t(rhs, Ninv)
            z_x = _dot(z_y, A) - wx
            tau_t = rtau + jnp.sum(z_y * hy) + jnp.sum(z_x * hx)
            y_new = z_y - vy
            rel_x = alpha * z_x + (1.0 - alpha) * x
            rel_tau = alpha * tau_t + (1.0 - alpha) * tau
            x_new = _prox(rel_x - vx, lam)
            tau_new = _prox(rel_tau - kappa, lam)
            vx_new = vx + x_new - rel_x
            kappa_new = kappa + tau_new - rel_tau
            return (y_new, x_new, vx_new, tau_new, kappa_new)

        def qres(y, x, vx, tau, kappa):
            # HSD-operator residual (`abip.c:1951-1996`): h = (-b; c), so
            # Ax - b*tau = Ax + tau*hy and b'y - c'x = -y.hy - x.hx
            q1 = _dot_t(x, A) + tau * hy
            q2 = _dot(y, A) + vx - tau * hx
            q3 = -jnp.sum(y * hy) - jnp.sum(x * hx) - kappa
            qsq = jnp.sum(q1 * q1) + jnp.sum(q2 * q2) + q3 * q3
            un = jnp.sum(y * y) + jnp.sum(x * x) + tau * tau
            vn = vy2 + jnp.sum(vx * vx) + kappa * kappa
            return jnp.sqrt(qsq) / (1.0 + jnp.sqrt(un + vn))

        def trip_cond(c):
            t = c[0]
            q = c[6]
            return jnp.logical_and(t < T, q >= thresh)

        def trip_body(c):
            t, y, x, vx, tau, kappa, _q = c
            y, x, vx, tau, kappa = jax.lax.fori_loop(
                0, probe, iter_body, (y, x, vx, tau, kappa))
            q = qres(y, x, vx, tau, kappa)
            return (t + probe, y, x, vx, tau, kappa, q)

        return jax.lax.while_loop(
            trip_cond, trip_body,
            (jnp.zeros((), jnp.int32), y, x, vx, tau0, kappa0,
             jnp.full((), jnp.inf, jnp.float32)))


def _row(x):
    return x.astype(jnp.float32)[None, :]


@partial(jax.jit, static_argnames=("T", "probe"))
def fused_admm_sprint_stop(A32, Ninv32, h32, g32, rho_y, g_th, lam, alpha,
                           thresh, u32, v32, T=768, probe=8):
    """Run UP TO T f32 ADMM iterations, stopping within `probe`-1
    iterations of the inner criterion `qres < thresh`.

    Returns (u, v, t_done, qres): the f32 iterate pair, the number of
    iterations actually executed (int32), and the final HSD-operator
    residual (f32).  vmap-able.

    Reference inner stop this implements: `abip.c:2131-2173` (the
    `iterate_Q_norm_resd < gamma*mu` break, checked every iteration).
    """
    m, n = A32.shape
    l = m + n + 1
    scalars = (
        jnp.asarray(rho_y, jnp.float32),
        (1.0 / (jnp.asarray(g_th, jnp.float64) + 1.0)).astype(jnp.float32),
        jnp.asarray(lam, jnp.float32),
        jnp.asarray(alpha, jnp.float32),
        u32[l - 1].astype(jnp.float32),
        v32[l - 1].astype(jnp.float32),
        jnp.asarray(thresh, jnp.float32),
    )
    t_done, y, x, vx, tau, kappa, q = _sprint_stop_ref(
        A32.astype(jnp.float32), Ninv32.astype(jnp.float32),
        _row(h32[:m]), _row(h32[m:m + n]), _row(g32[:m]),
        _row(g32[m:m + n]), scalars,
        _row(u32[:m]), _row(u32[m:m + n]), _row(v32[:m]),
        _row(v32[m:m + n]), T, probe)
    u_out = jnp.concatenate([y[0], x[0], tau[None]])
    v_out = jnp.concatenate([v32[:m].astype(jnp.float32), vx[0],
                             kappa[None]])
    return u_out, v_out, t_done, q


@partial(jax.jit, static_argnames=("T",))
def fused_admm_sprint(A32, Ninv32, h32, g32, rho_y, g_th, lam, alpha,
                      u32, v32, T=32):
    """Run T f32 ADMM iterations; returns (u, v).

    A32 (m, n), Ninv32 (m, m) = (rho_y I + A A')^-1, h32/g32 (l,) the HSD
    rank-1 data (`abip.c:1917-1924`), lam = mu/beta.
    """
    scalars = (jnp.asarray(rho_y, jnp.float32),
               1.0 / (jnp.asarray(g_th, jnp.float32) + 1.0),
               jnp.asarray(lam, jnp.float32),
               jnp.asarray(alpha, jnp.float32))
    return _sprint_ref(A32, Ninv32, h32, g32, scalars, u32, v32, T,
                       A32.shape[0])
