"""Fused conic DR sprint: T whole f32 QCP iterations in one XLA loop.

Runs up to T complete conic Douglas-Rachford iterations -- projection
with the quadratic-formula tau (`source/abip.c:186-254`), cone barrier
prox (`source/cones.c:130-289`), dual update (`source/abip.c:314`) --
inside one loop, probing the inner stopping criterion
(`qcp_inner_conv_check`, `source/qcp_config.c:518-557`) every `probe`
iterations.  `fused_dr_ladder` runs the whole phase-1 barrier ladder
the same way.

Cone prox without scatters: the segment reductions of
`cones._soc_blocks`/`_rsoc_blocks` become products against 0/1
block-indicator matrices (Mh1: block-head rows, Mh2: RSOC second
heads, Mb: block bodies), and the scatter-back is the transpose
product.  Per-block formulas stay the branch-free selects of
`abip.cones` (f32).  Vectors ride unpadded (1, k) rows.
HIGHEST-precision f32 products (a reduced-precision product destroys
the cancellation-heavy tau quadratic).

f32 only: the inner engine of the conic anchored mixed-precision
scheme -- sprint while mu is large, anchored-f64 endgame below the
switch (`parallel/batched_qcp.py`).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

_TINY = 1e-30
_SOC_TOL = 1e-6
_EPS_TAU = 1e-18


def _c(v):
    """f32 constant for jnp.where branches: under x64 mode a Python
    literal in `where` promotes the f32 result to f64."""
    return jnp.float32(v)

f32 = jnp.float32


def _dot_t(a, M):
    """(1, k) x (r, k) -> (1, r): contract a's columns with M's rows
    (HIGHEST: see admm_sprint._dot_t)."""
    return jax.lax.dot_general(a, M, (((1,), (1,)), ((), ())),
                               preferred_element_type=jnp.float32,
                               precision=jax.lax.Precision.HIGHEST)


def _dot(a, M):
    """(1, r) x (r, k) -> (1, k)."""
    return jax.lax.dot_general(a, M, (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.float32,
                               precision=jax.lax.Precision.HIGHEST)


def _prox_nn(t, lam):
    """Positive-orthant barrier prox (`cones.c:279-289`), branch-free."""
    pos = 0.5 * (t + jnp.sqrt(t * t + 4.0 * lam))
    neg = 2.0 * lam / (
        -t * (1.0 + jnp.sqrt(1.0 + 4.0 * lam / (t * t + _TINY))) + _TINY)
    return jnp.where(t >= 0, pos, neg)


def _soc_rows(a, bsq, lam):
    """SOC barrier prox per block row (`cones.c:130-161`); operands are
    (1, nbp) rows.  Returns (head_value, body_scale)."""
    x0_zero = jnp.sqrt(2.0 * lam + bsq / 4.0)
    denom_r = 8.0 * lam - a * a + bsq
    r = 16.0 * a * a / (
        denom_r + jnp.sqrt(denom_r * denom_r + 32.0 * a * a * lam) + _TINY)
    disc = jnp.sqrt(jnp.maximum(r * (r + 8.0), 0.0))
    s = jnp.where(a > 0, (r + disc) / 2.0, (r - disc) / 2.0)
    s_safe = jnp.where(jnp.abs(s) < _TINY, _c(_TINY), s)
    eta = (s + 2.0) * a / s_safe
    scale_pos = (s + 2.0) / (s + 4.0)
    small = jnp.abs(a) <= _SOC_TOL
    return (jnp.where(small, x0_zero, eta),
            jnp.where(small, _c(0.5), scale_pos))


def _rsoc_rows(ze, zn, zxsq, lam):
    """RSOC barrier prox per block row (`cones.c:169-248`); (1, nbp)
    rows.  Returns (head1, head2, body_scale)."""
    sum_zz = ze + zn
    d = 2.0 * ze * zn - zxsq
    g = d / (2.0 * lam)
    g_neg = jnp.where(g < 0, -g, _c(1.0))
    g_pos = jnp.where(g > 0, g, _c(1.0))
    q = 4.0 * (ze * ze + zn * zn + zxsq) / lam + 16.0
    w_neg = (2.0 * sum_zz * sum_zz / lam) / g_neg / (
        1.0 + 4.0 / g_neg + jnp.sqrt(1.0 + q / (g_neg * g_neg)))
    w_pos = g_pos * (
        1.0 - 4.0 / g_pos + jnp.sqrt(1.0 + q / (g_pos * g_pos))) / 2.0
    w = jnp.where(d < 0, w_neg, w_pos)
    root = jnp.sqrt(jnp.maximum(w * (w + 4.0), 0.0))
    s_a = (w + root) / 2.0
    s_b = 2.0 / (w + 2.0 + root + _TINY)
    s_c = (w - root) / 2.0

    def heads_std(s):
        den = s * (s + 2.0)
        den = jnp.where(jnp.abs(den) < _TINY, _c(_TINY), den)
        x1 = (ze * (s + 1.0) ** 2 + zn * (s + 1.0)) / den
        x2 = (zn * (s + 1.0) ** 2 + ze * (s + 1.0)) / den
        return x1, x2, (s + 1.0) / (s + 2.0)

    def heads_b(s):
        den = (s - 1.0) * (s + 1.0)
        den = jnp.where(jnp.abs(den) < _TINY, _c(_TINY), den)
        x1 = (ze * s * s + zn * s) / den
        x2 = (zn * s * s + ze * s) / den
        return x1, x2, s / (s + 1.0)

    xa1, xa2, sca = heads_std(s_a)
    xb1, xb2, scb = heads_b(s_b)
    xc1, xc2, scc = heads_std(s_c)
    pos_branch = sum_zz > 0
    b_branch = (~pos_branch) & (w > 10.0)
    x1 = jnp.where(pos_branch, xa1, jnp.where(b_branch, xb1, xc1))
    x2 = jnp.where(pos_branch, xa2, jnp.where(b_branch, xb2, xc2))
    sc = jnp.where(pos_branch, sca, jnp.where(b_branch, scb, scc))
    x2_deg = (-ze + jnp.sqrt(ze * ze + 4.0 * lam + zxsq)) / 2.0
    deg = sum_zz == 0
    x1 = jnp.where(deg, x2_deg + ze, x1)
    x2 = jnp.where(deg, x2_deg, x2)
    sc = jnp.where(deg, _c(0.5), sc)
    return x1, x2, sc


class ConeKernelData(NamedTuple):
    """f32 cone-structure operands for the fused DR loops.

    Built once at setup by `cone_kernel_data`; all leaves are arrays so
    a heterogeneous batch can vmap over them."""

    mask_nn: jnp.ndarray    # (1, n)  nonneg elements
    mask_free: jnp.ndarray  # (1, n)  free elements
    mask_blk: jnp.ndarray   # (1, n)  SOC|RSOC elements
    Mh1: jnp.ndarray        # (nb, n) block-head indicator
    Mh2: jnp.ndarray        # (nb, n) RSOC 2nd-head indicator
    Mb: jnp.ndarray         # (nb, n) block-body indicator
    soc_blk: jnp.ndarray    # (1, nb) 1 where the block is SOC


def cone_kernel_data(layout) -> ConeKernelData:
    """Indicator-matrix encoding of a `ConeLayout` for the DR loops.

    The segment_sum/scatter pairs of `cones.cone_barrier_prox` become
    products against these 0/1 matrices (no scatters)."""
    kind = np.asarray(layout.kind)
    seg = np.asarray(layout.seg)
    head = np.asarray(layout.head)
    n = kind.shape[0]
    nb = max(1, int(layout.num_blocks))
    _NONNEG, _FREE, _ZERO, _SOC, _RSOC = 0, 1, 2, 3, 4

    def row(mask):
        return mask.astype(np.float32)[None, :]

    Mh1 = np.zeros((nb, n), np.float32)
    Mh2 = np.zeros((nb, n), np.float32)
    Mb = np.zeros((nb, n), np.float32)
    soc_blk = np.zeros((1, nb), np.float32)
    in_blk = (kind == _SOC) | (kind == _RSOC)
    idx = np.arange(n)
    h1 = in_blk & (head == 1)
    h2 = in_blk & (head == 2)
    body = in_blk & (head == 0)
    Mh1[seg[h1], idx[h1]] = 1.0
    Mh2[seg[h2], idx[h2]] = 1.0
    Mb[seg[body], idx[body]] = 1.0
    soc_seg = np.unique(seg[kind == _SOC])
    soc_blk[0, soc_seg] = 1.0
    return ConeKernelData(
        mask_nn=jnp.asarray(row(kind == _NONNEG)),
        mask_free=jnp.asarray(row(kind == _FREE)),
        mask_blk=jnp.asarray(row(in_blk)),
        Mh1=jnp.asarray(Mh1), Mh2=jnp.asarray(Mh2), Mb=jnp.asarray(Mb),
        soc_blk=jnp.asarray(soc_blk))


def _cone_prox(tx, lam_x, cd: ConeKernelData):
    """Full cone barrier prox on a (1, n) row (f32, matmul segments)."""
    out = cd.mask_nn * _prox_nn(tx, lam_x) + cd.mask_free * tx
    # block reductions as matmuls
    S1 = _dot_t(tx, cd.Mh1)          # (1, nbp) head values
    S2 = _dot_t(tx, cd.Mh2)
    SB = _dot_t(tx * tx, cd.Mb)      # body sum-of-squares
    soc_h, soc_s = _soc_rows(S1, SB, lam_x)
    rs1, rs2, rs_s = _rsoc_rows(S1, S2, SB, lam_x)
    h1v = jnp.where(cd.soc_blk > 0, soc_h, rs1)
    scv = jnp.where(cd.soc_blk > 0, soc_s, rs_s)
    xb = _dot(h1v, cd.Mh1) + _dot(rs2, cd.Mh2) + tx * _dot(scv, cd.Mb)
    return out + cd.mask_blk * xb


def _make_dr_fns(A, Minv, H_inv, ry, rx, b, c, Qd, cd,
                 rho_y, rho_x, rho_tau, a_coef, alpha, k0, woodbury):
    """The two per-iteration closures of the fused DR engines:
    `iter_body(lam)(i, carry)` (one conic DR iteration at barrier lam)
    and `err_inner(carry)` (`qcp_inner_conv_check`,
    `qcp_config.c:518-557`, in f32).  Shared by the single-stage sprint
    and the multi-stage ladder."""
    inv_ry = 1.0 / rho_y

    def solve_S(rhs):
        if woodbury:
            t = H_inv * rhs
            u = _dot_t(_dot_t(t, A), Minv)       # Ginv @ (A t)
            return t - H_inv * _dot(u, A)
        return _dot(rhs, Minv)                    # Sinv symmetric

    def iter_body_at(lam):
        lam_x = lam / rho_x
        lam_tau = lam / rho_tau

        def iter_body(i, carry):
            y, x, vy, vx, tau, kappa = carry
            wy = rho_y * (y + vy)
            wx = rho_x * (x + vx)
            eta = rho_tau * (tau + kappa)
            rhs = wx + inv_ry * _dot(wy, A)       # w_x + A'(w_y/rho_y)
            zx = solve_S(rhs)
            Az = _dot_t(zx, A)                    # (1, m)
            zy = inv_ry * (wy - Az)
            b_coef = (jnp.sum(ry * wy) + jnp.sum(rx * wx)
                      - 2.0 * (rho_y * jnp.sum(ry * zy)
                               + rho_x * jnp.sum(rx * zx)) - eta)
            c_coef = -jnp.sum(zx * Qd * zx)
            disc = jnp.maximum(b_coef * b_coef - 4.0 * a_coef * c_coef, 0.0)
            tau_t = (-b_coef + jnp.sqrt(disc)) / (2.0 * a_coef)
            tau_t = jnp.where(k0 + i.astype(f32) > 0, tau_t, _c(1.0))
            uty = zy - tau_t * ry
            utx = zx - tau_t * rx
            rel_y = alpha * uty + (1.0 - alpha) * y
            rel_x = alpha * utx + (1.0 - alpha) * x
            rel_tau = alpha * tau_t + (1.0 - alpha) * tau
            ty = rel_y - vy
            tx = rel_x - vx
            ttau = rel_tau - kappa
            y_new = ty                            # free-cone head
            x_new = _cone_prox(tx, lam_x, cd)
            tau_new = _prox_nn(ttau, lam_tau)
            vy_new = vy + y_new - rel_y           # identically 0 after 1 iter
            vx_new = vx + x_new - rel_x
            kappa_new = kappa + tau_new - rel_tau
            return (y_new, x_new, vy_new, vx_new, tau_new, kappa_new)

        return iter_body

    def err_inner(y, x, vy, vx, tau, kappa):
        # `qcp_inner_conv_check` (`qcp_config.c:518-557`) in f32
        Mu_y = _dot_t(x, A)                        # A x
        Mu_x = Qd * x - _dot(y, A)                 # Qx - A'y
        Qu_y = Mu_y - b * tau
        Qu_x = Mu_x + c * tau
        tau_safe = jnp.where(jnp.abs(tau) < _EPS_TAU, _c(_EPS_TAU), tau)
        Qu_tau = (-(jnp.sum(y * Mu_y) + jnp.sum(x * Mu_x)) / tau_safe
                  + jnp.sum(y * b) - jnp.sum(x * c))
        von_y = rho_y * vy
        von_x = rho_x * vx
        von_tau = rho_tau * kappa
        d2 = (jnp.sum((Qu_y - von_y) ** 2) + jnp.sum((Qu_x - von_x) ** 2)
              + (Qu_tau - von_tau) ** 2)
        qn = jnp.sqrt(jnp.sum(Qu_y * Qu_y) + jnp.sum(Qu_x * Qu_x)
                      + Qu_tau * Qu_tau)
        vn = jnp.sqrt(jnp.sum(von_y * von_y) + jnp.sum(von_x * von_x)
                      + von_tau * von_tau)
        return jnp.sqrt(d2) / (1.0 + qn + vn)

    return iter_body_at, err_inner


def _dr_sprint_compute(scal, A, Minv, H_inv, ry, rx, b, c, Qd, cd,
                       y0, x0, vy0, vx0, *, T, probe, woodbury):
    """Up to T f32 conic DR iterations with the inner-criterion stop
    every `probe` iterations.  Vector operands are (1, k) rows.

    Minv: Sinv (n, n) when not woodbury, else Ginv (m, m) with
    H_inv (1, n) the diagonal dual-form inverse.
    Returns (y, x, vy, vx, out_row) with out_row (1, 128) holding
    [tau, kappa, err, t_done]."""
    rho_y = scal[0, 0]
    rho_x = scal[0, 1]
    rho_tau = scal[0, 2]
    a_coef = scal[0, 3]
    lam = scal[0, 4]
    alpha = scal[0, 5]
    tau0 = scal[0, 6]
    kappa0 = scal[0, 7]
    thresh = scal[0, 8]
    k0 = scal[0, 9]
    iter_body_at, err_inner = _make_dr_fns(
        A, Minv, H_inv, ry, rx, b, c, Qd, cd,
        rho_y, rho_x, rho_tau, a_coef, alpha, k0, woodbury)
    iter_body = iter_body_at(lam)

    def trip_cond(cry):
        t = cry[0]
        e = cry[7]
        return jnp.logical_and(t < T, e >= thresh)

    def trip_body(cry):
        t, y, x, vy, vx, tau, kappa, _e = cry
        y, x, vy, vx, tau, kappa = jax.lax.fori_loop(
            t, t + probe, iter_body, (y, x, vy, vx, tau, kappa))
        e = err_inner(y, x, vy, vx, tau, kappa)
        return (t + probe, y, x, vy, vx, tau, kappa, e)

    t, y, x, vy, vx, tau, kappa, e = jax.lax.while_loop(
        trip_cond, trip_body,
        (jnp.zeros((), jnp.int32), y0, x0, vy0, vx0, tau0, kappa0,
         jnp.full((), jnp.inf, f32)))
    col = jax.lax.broadcasted_iota(jnp.int32, (1, 128), 1)
    z = _c(0.0)
    out = jnp.where(col == 0, tau, z)
    out = out + jnp.where(col == 1, kappa, z)
    out = out + jnp.where(col == 2, e, z)
    out = out + jnp.where(col == 3, t.astype(f32), z)
    return y, x, vy, vx, out.astype(f32)


def _row(x):
    """(k,) vector -> (1, k) f32 row."""
    return x.astype(f32)[None, :]


def _check_width(cd, n):
    if cd.mask_nn.shape[-1] != n:
        raise ValueError(f"cone kernel data built at width "
                         f"{cd.mask_nn.shape[-1]}, problem width is {n}")


@partial(jax.jit, static_argnames=("T", "probe", "woodbury"))
def fused_dr_sprint_stop(A32, Minv32, Hinv32, r_vec32, b32, c32, Qd32,
                         cd: ConeKernelData, rho_y, rho_x, rho_tau,
                         a_coef, lam, alpha, thresh, u32, v32, k0,
                         T=512, probe=8, woodbury=False):
    """Run UP TO T f32 conic DR iterations in one launch, stopping
    within `probe`-1 iterations of the inner criterion `err < thresh`.

    A32 (m, n); Minv32 = Sinv (n, n) or (woodbury=True) Ginv (m, m)
    with Hinv32 (n,) the diagonal H^-1; r_vec32 (m+n,) and a_coef the
    tau-quadratic precompute (`pre_calculate`, `source/abip.c:886-910`);
    Qd32 (n,) the DIAGONAL quadratic term (zeros when Q is absent);
    cd from `cone_kernel_data` of the problem's cone layout.

    Returns (u, v, t_done, err): f32 iterates (length m+n+1), the
    iteration count executed, and the final inner-criterion value.
    vmap-able.
    """
    m, n = A32.shape
    l = m + n + 1
    _check_width(cd, n)
    scal_row = jnp.zeros((1, 128), f32)
    for i, s in enumerate((rho_y, rho_x, rho_tau, a_coef, lam, alpha,
                           u32[l - 1], v32[l - 1], thresh, k0)):
        scal_row = scal_row.at[0, i].set(jnp.asarray(s).astype(f32))
    vecs = [_row(x) for x in (Hinv32, r_vec32[:m], r_vec32[m:], b32, c32,
                              Qd32, u32[:m], u32[m:m + n], v32[:m],
                              v32[m:m + n])]
    Hinv_r, ry, rx, b_r, c_r, Qd_r, y0, x0, vy0, vx0 = vecs
    with jax.default_matmul_precision("highest"):
        y, x, vy, vx, sc = _dr_sprint_compute(
            scal_row, A32.astype(f32), Minv32.astype(f32), Hinv_r, ry, rx,
            b_r, c_r, Qd_r, cd, y0, x0, vy0, vx0, T=T, probe=probe,
            woodbury=woodbury)
    tau, kappa = sc[0, 0], sc[0, 1]
    err = sc[0, 2]
    t_done = sc[0, 3].astype(jnp.int32)
    u_out = jnp.concatenate([y[0], x[0], tau[None]])
    v_out = jnp.concatenate([vy[0], vx[0], kappa[None]])
    return u_out, v_out, t_done, err


# ---------------------------------------------------------------------------
# Multi-stage barrier ladder: the WHOLE conic phase 1 in one loop.
#
# The per-stage sprint engine pays a fixed per-stage cost (dispatch +
# operand streaming + the vmapped f64 residual round between stages) for
# ~8 f32 iterations of actual work.  The ladder carries
# (mu, tol_inner) through the sigma/gamma tables of `adjust_barrier`
# (`source/abip.c:994-1071`) inside the loop, with the error-ratio input computed
# from f32 residuals (`calc_qcp_residuals`, `qcp_config.c:562-691`): during
# phase 1 the residuals sit orders of magnitude above eps, so f32 evaluates
# the >=22 bucket (and the mu/eps gamma table) exactly; the f64 residual
# pass and certificate checks run ONCE after the ladder returns.
# ---------------------------------------------------------------------------

def _adjust_barrier_f32(mu, err_ratio, eps, psi):
    """`adjust_barrier` (`source/abip.c:994-1071`) as f32 scalar selects
    (searchsorted tables unrolled into where-chains)."""
    ratio = mu / eps
    redges = (5e-5, 1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2, 1e-1, 0.5, 1.0,
              5.0, 10.0, 50.0, 100.0)
    rvals = (0.5, 0.6, 0.6, 0.7, 0.7, 0.8, 0.8, 0.9, 0.9, 1.0, 1.1, 1.2,
             1.3, 1.5, 0.5)
    gamma = _c(rvals[0])
    for e, v in zip(redges, rvals[1:]):
        gamma = jnp.where(ratio >= e, _c(v), gamma)
    medges = (1.5, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 15.0, 18.0, 22.0)
    gmul = (2.4, 2.6, 2.8, 3.2, 3.4, 3.4, 3.6, 3.8, 4.0, 4.2, 4.4)
    sigv = (0.85, 0.85, 0.85, 0.83, 0.82, 0.81, 0.8, 0.8, 0.8, 0.8, 0.8)
    gm = _c(gmul[0])
    sg = _c(sigv[0])
    for e, gv, sv in zip(medges, gmul[1:], sigv[1:]):
        gm = jnp.where(err_ratio >= e, _c(gv), gm)
        sg = jnp.where(err_ratio >= e, _c(sv), sg)
    mu_new = sg * _c(0.2) * mu
    tol = gamma * gm * (mu_new if psi == 1.0 else mu_new ** _c(psi))
    return mu_new, tol


# ladder scal-row slots (beyond the sprint's 0..9)
(_L_RHOY, _L_RHOX, _L_RHOT, _L_ACOEF, _L_MU, _L_ALPHA, _L_TAU, _L_KAPPA,
 _L_TOL, _L_K0, _L_MUSTOP, _L_EPS, _L_SCB, _L_SCC, _L_NMB, _L_NMC) = range(16)


def _dr_ladder_compute(scal, A, Minv, H_inv, ry, rx, b, c, Qd, D, E, cd,
                       y0, x0, vy0, vx0, *, T, probe, psi, woodbury):
    """Up to T f32 conic DR iterations across AS MANY barrier stages as
    fit, stopping when mu drops below mu_stop.  Returns
    (y, x, vy, vx, out_row) with out_row (1, 128) packing
    [tau, kappa, err, t_done, mu, tol, stages]."""
    rho_y = scal[0, _L_RHOY]
    rho_x = scal[0, _L_RHOX]
    rho_tau = scal[0, _L_RHOT]
    a_coef = scal[0, _L_ACOEF]
    mu0 = scal[0, _L_MU]
    alpha = scal[0, _L_ALPHA]
    tau0 = scal[0, _L_TAU]
    kappa0 = scal[0, _L_KAPPA]
    tol0 = scal[0, _L_TOL]
    k0 = scal[0, _L_K0]
    mu_stop = scal[0, _L_MUSTOP]
    eps = scal[0, _L_EPS]
    sc_b = scal[0, _L_SCB]
    sc_c = scal[0, _L_SCC]
    nm_b = scal[0, _L_NMB]
    nm_c = scal[0, _L_NMC]
    iter_body_at, err_inner = _make_dr_fns(
        A, Minv, H_inv, ry, rx, b, c, Qd, cd,
        rho_y, rho_x, rho_tau, a_coef, alpha, k0, woodbury)

    def error_ratio_f32(y, x, vx, tau):
        """max(res/eps) of `calc_qcp_residuals` in f32 (phase-1 regime:
        residuals >> eps, so f32 classifies the sigma/gamma buckets
        exactly; see module comment)."""
        tau_s = jnp.maximum(jnp.abs(tau), _c(1e-18))
        xs = x / tau_s
        ys = y / tau_s
        ss = rho_x * vx / tau_s
        Ax = _dot_t(xs, A)
        DAx = D * Ax
        res_pri = jnp.max(jnp.abs(D * (Ax - b))) / (
            sc_b + jnp.maximum(jnp.max(jnp.abs(DAx)), sc_b * nm_b))
        Qx = Qd * xs
        ATy = _dot(ys, A)
        dres = Qx - ATy + c - ss
        res_dual = jnp.max(jnp.abs(E * dres)) / (
            sc_c + jnp.maximum(sc_c * nm_c, jnp.max(jnp.abs(E * Qx))))
        inv_bc = 1.0 / (sc_b * sc_c)
        xQx_2 = 0.5 * jnp.sum(xs * Qx) * inv_bc
        cTx = jnp.sum(c * xs) * inv_bc
        bTy = jnp.sum(b * ys) * inv_bc
        rel_gap = jnp.abs(2.0 * xQx_2 + cTx - bTy) / (
            1.0 + jnp.maximum(2.0 * xQx_2,
                              jnp.maximum(jnp.abs(cTx), jnp.abs(bTy))))
        return jnp.maximum(res_pri,
                           jnp.maximum(res_dual, rel_gap)) / eps

    # ONE flat loop: each trip runs `probe` iterations
    # at the CURRENT mu, probes the inner criterion, and -- when it
    # fires -- advances (mu, tol) through the barrier tables in place.
    # A stage is thus consecutive trips at fixed mu until the criterion
    # fires at a probe boundary, exactly the per-stage driver semantics
    # (>= 1 trip per stage, since the check follows the iterations).
    def trip_cond(s):
        t, stages, y, x, vy, vx, tau, kappa, mu, tol, e = s
        return jnp.logical_and(t < T, mu >= mu_stop)

    def trip_body(s):
        t, stages, y, x, vy, vx, tau, kappa, mu, tol, _e = s
        y, x, vy, vx, tau, kappa = jax.lax.fori_loop(
            t, t + probe, iter_body_at(mu), (y, x, vy, vx, tau, kappa))
        t = t + probe
        e = err_inner(y, x, vy, vx, tau, kappa)
        ratio = error_ratio_f32(y, x, vx, tau)
        mu2, tol2 = _adjust_barrier_f32(mu, ratio, eps, psi)
        adv = e < tol
        mu = jnp.where(adv, mu2, mu)
        tol = jnp.where(adv, tol2, tol)
        # int32 literals: a bare Python 1 promotes to int64 under x64
        # (same family as the _c() f64 guard above)
        stages = stages + jnp.where(adv, jnp.int32(1), jnp.int32(0))
        return (t, stages, y, x, vy, vx, tau, kappa, mu, tol, e)

    t, stages, y, x, vy, vx, tau, kappa, mu, tol, e = jax.lax.while_loop(
        trip_cond, trip_body,
        (jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
         y0, x0, vy0, vx0, tau0, kappa0, mu0, tol0,
         jnp.full((), jnp.inf, f32)))
    col = jax.lax.broadcasted_iota(jnp.int32, (1, 128), 1)
    z = _c(0.0)
    out = jnp.where(col == 0, tau, z)
    out = out + jnp.where(col == 1, kappa, z)
    out = out + jnp.where(col == 2, e, z)
    out = out + jnp.where(col == 3, t.astype(f32), z)
    out = out + jnp.where(col == 4, mu, z)
    out = out + jnp.where(col == 5, tol, z)
    out = out + jnp.where(col == 6, stages.astype(f32), z)
    return y, x, vy, vx, out.astype(f32)


@partial(jax.jit, static_argnames=("T", "probe", "psi", "woodbury"))
def fused_dr_ladder(A32, Minv32, Hinv32, r_vec32, b32, c32, Qd32, D32, E32,
                    cd: ConeKernelData, rho_y, rho_x, rho_tau, a_coef,
                    mu, tol_inner, mu_stop, eps, sc_b, sc_c, nm_inf_b,
                    nm_inf_c, alpha, u32, v32, k0, T=2048, probe=8,
                    psi=1.0, woodbury=False):
    """Run the conic barrier LADDER (phase 1) in one loop: up to T f32
    DR iterations across as many barrier stages as fit, advancing
    (mu, tol_inner) through the `adjust_barrier` tables until
    mu < mu_stop (or the T cap: re-enter with the returned state).

    Same operand conventions as `fused_dr_sprint_stop`, plus D32/E32
    (the equilibration scalings, for the f32 error-ratio) and
    the (mu, tol_inner, mu_stop, eps, sc_b, sc_c, nm_inf_b, nm_inf_c)
    scalars.  Returns (u, v, t_done, err, mu, tol_inner, stages)."""
    m, n = A32.shape
    l = m + n + 1
    _check_width(cd, n)
    scal_row = jnp.zeros((1, 128), f32)
    for i, s in enumerate((rho_y, rho_x, rho_tau, a_coef, mu, alpha,
                           u32[l - 1], v32[l - 1], tol_inner, k0,
                           mu_stop, eps, sc_b, sc_c, nm_inf_b, nm_inf_c)):
        scal_row = scal_row.at[0, i].set(jnp.asarray(s).astype(f32))
    vecs = [_row(x) for x in (Hinv32, r_vec32[:m], r_vec32[m:], b32, c32,
                              Qd32, D32, E32, u32[:m], u32[m:m + n],
                              v32[:m], v32[m:m + n])]
    Hinv_r, ry, rx, b_r, c_r, Qd_r, D_r, E_r, y0, x0, vy0, vx0 = vecs
    with jax.default_matmul_precision("highest"):
        y, x, vy, vx, sc = _dr_ladder_compute(
            scal_row, A32.astype(f32), Minv32.astype(f32), Hinv_r, ry, rx,
            b_r, c_r, Qd_r, D_r, E_r, cd, y0, x0, vy0, vx0, T=T,
            probe=probe, psi=psi, woodbury=woodbury)
    tau, kappa = sc[0, 0], sc[0, 1]
    err = sc[0, 2]
    t_done = sc[0, 3].astype(jnp.int32)
    mu_out = sc[0, 4]
    tol_out = sc[0, 5]
    stages = sc[0, 6].astype(jnp.int32)
    u_out = jnp.concatenate([y[0], x[0], tau[None]])
    v_out = jnp.concatenate([vy[0], vx[0], kappa[None]])
    return u_out, v_out, t_done, err, mu_out, tol_out, stages
