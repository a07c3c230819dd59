"""Anchored-delta CONIC DR endgame: f32 iterations at f64 accuracy.

The conic device route's endgame holds ~97% of its iterations (the
barrier passes the sprint switch after ~32).  This module carries the LP
delta engine (`ops/admm_delta.py`) over to the conic Douglas-Rachford
iteration of `ops/conic_sprint.py` / `parallel/batched_qcp.py`: f32
iterations on deltas from a per-chunk f64 anchor, in plain XLA.  Design
derivation: docs/conic_delta_design.md.

Delta-frame rules (same as the LP module):

* The anchor is the EXACT f64 entry state; anchor IMAGES (the E-terms
  `F(anchor) - anchor`, the prox argument anchors, the inner-criterion
  anchors) are computed once per chunk in f64 outside the chunk loop.
* Every in-loop quantity is small (a delta), so f32's relative error is
  absolute error ~1e-7 * ||delta||.
* Nonlinear maps are differenced ALGEBRAICALLY, one intermediate at a
  time, with the O(1) parts factored out (never difference O(1)
  values); differencing two O(delta) terms is fine.
* Branch seams (sign(a), |a|<=tol, RSOC d<>0, degenerate blocks): when
  anchor and current take different branches the telescoped identities
  break -- those (rare, boundary-width) cases fall back to the direct
  f32 difference of the recomputed chain values, an O(1e-7) absolute
  error absorbed by the next anchor refresh.

The tau step solves the DR quadratic (`source/abip.c:186-254`); its
delta uses  ds = ((b0 + b) db - 4 a dc) / (s + s0)  with b linear and
c = -z'Qz quadratic in the delta (Qz0 precomputed).

The cone prox delta P(dt) := prox(t0 + dt) - prox(t0) is built so that
P(0) == 0 STRUCTURALLY (every formula is a product with a delta
factor), which is what lets the per-block anchor chains (r0, disc0,
s0, ...) be recomputed in f32 inside the loop from the stored f32
`t0` row: their O(1) rounding only perturbs coefficients multiplying
deltas.

Reference math: SOC/RSOC barrier prox `cones.c:130-248`, orthant
`cones.c:279-289`, inner criterion `qcp_config.c:518-557`.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .conic_sprint import ConeKernelData, _dot, _dot_t, _row

f32 = jnp.float32
f64 = jnp.float64
_TINY = 1e-30
_SOC_TOL = 1e-6
_EPS_TAU = 1e-18


# ---------------------------------------------------------------------------
# absolute chains (f32) -- shared by the anchor recomputation and the
# branch-mismatch fallbacks; EXACTLY the formulas of conic_sprint
# ---------------------------------------------------------------------------

def _soc_chain(a, bsq, lam):
    """(a, bsq) -> (x0_zero, denom, R, D, r, disc, s, eta, sc, small)."""
    x0_zero = jnp.sqrt(2.0 * lam + bsq / 4.0)
    denom = 8.0 * lam - a * a + bsq
    R = jnp.sqrt(denom * denom + 32.0 * a * a * lam)
    D = denom + R + _TINY
    r = 16.0 * a * a / D
    disc = jnp.sqrt(jnp.maximum(r * (r + 8.0), 0.0))
    s = jnp.where(a > 0, (r + disc) / 2.0, (r - disc) / 2.0)
    s_safe = jnp.where(jnp.abs(s) < _TINY, jnp.float32(_TINY), s)
    eta = (s + 2.0) * a / s_safe
    sc = (s + 2.0) / (s + 4.0)
    small = jnp.abs(a) <= _SOC_TOL
    eta = jnp.where(small, x0_zero, eta)
    sc = jnp.where(small, jnp.float32(0.5), sc)
    return x0_zero, denom, R, D, r, disc, s, s_safe, eta, sc, small


def _rsoc_chain(ze, zn, zxsq, lam):
    """(ze, zn, zxsq) -> intermediates + (x1, x2, sc) + branch masks."""
    sum_zz = ze + zn
    d = 2.0 * ze * zn - zxsq
    g = d / (2.0 * lam)
    g_neg = jnp.where(g < 0, -g, jnp.float32(1.0))
    g_pos = jnp.where(g > 0, g, jnp.float32(1.0))
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
        den = jnp.where(jnp.abs(den) < _TINY, jnp.float32(_TINY), den)
        x1 = (ze * (s + 1.0) ** 2 + zn * (s + 1.0)) / den
        x2 = (zn * (s + 1.0) ** 2 + ze * (s + 1.0)) / den
        return x1, x2, (s + 1.0) / (s + 2.0)

    def heads_b(s):
        den = (s - 1.0) * (s + 1.0)
        den = jnp.where(jnp.abs(den) < _TINY, jnp.float32(_TINY), den)
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
    sc = jnp.where(deg, jnp.float32(0.5), sc)
    return x1, x2, sc, pos_branch, b_branch, deg


def _prox_nn_delta(dt, t0, lam):
    """Orthant barrier-prox delta (LP `_prox_delta` with in-chain s0)."""
    s0 = jnp.sqrt(t0 * t0 + 4.0 * lam)
    t = t0 + dt
    s = jnp.sqrt(t * t + 4.0 * lam)
    ds = dt * (t0 + t) / (s + s0)
    pos = 0.5 * (dt + ds)
    neg = 2.0 * lam * (dt - ds) / ((s - t) * (s0 - t0) + _TINY)
    return jnp.where(t >= 0, pos, neg)


def _soc_delta(a0, bsq0, da, dbsq, lam):
    """Stable (d_eta, d_sc) for the SOC chain; falls back to the direct
    f32 chain difference on branch mismatches."""
    (x0z0, den0, R0, D0, r0, disc0, s0, s0_safe, eta0, sc0,
     small0) = _soc_chain(a0, bsq0, lam)
    a = a0 + da
    bsq = bsq0 + dbsq
    (x0z, den, R, D, r, disc, s, s_safe, eta_c, sc_c,
     small) = _soc_chain(a, bsq, lam)
    # telescoped identities (exact in exact arithmetic, same branch)
    dx0z = (dbsq / 4.0) / (x0z + x0z0 + _TINY)
    dden = -(a0 + a) * da + dbsq
    dR = ((den0 + den) * dden + 32.0 * lam * (a0 + a) * da) / (R + R0 + _TINY)
    dD = dden + dR
    dr = (16.0 * (a0 + a) * da - r0 * dD) / D
    ddisc = (r0 + r + 8.0) * dr / (disc + disc0 + _TINY)
    # f32 literals: two bare Python floats in where() promote to
    # f64 under x64
    sgn = jnp.where(a > 0, jnp.float32(1.0), jnp.float32(-1.0))
    ds = (dr + sgn * ddisc) / 2.0
    # eta = a + 2a/s  ->  d = da + 2 (da s0 - a0 ds) / (s s0)
    d_eta = da + 2.0 * (da * s0_safe - a0 * ds) / (s_safe * s0_safe)
    d_sc = 2.0 * ds / ((s + 4.0) * (s0 + 4.0))
    # small-|a| branch: eta=x0_zero, sc=1/2
    d_eta = jnp.where(small0 & small, dx0z, d_eta)
    d_sc = jnp.where(small0 & small, jnp.float32(0.0), d_sc)
    # branch mismatch (sign flip or small-flag flip): direct difference
    mismatch = (small0 != small) | ((a0 > 0) != (a > 0))
    d_eta = jnp.where(mismatch, eta_c - eta0, d_eta)
    d_sc = jnp.where(mismatch, sc_c - sc0, d_sc)
    return d_eta, d_sc


def _rsoc_delta(ze0, zn0, zx0, dze, dzn, dzx, lam):
    """Stable (d_x1, d_x2, d_sc) for the RSOC chain (`cones.c:169-248`).

    Same telescoping discipline as `_soc_delta`: every intermediate's
    delta is an exact algebraic identity given the previous deltas, so
    the result is exact at zero delta and relatively accurate
    otherwise.  w_pos uses the algebraic rewrite
    g (1 - 4/g + sqrt(1 + q/g^2)) = g - 4 + sqrt(g^2 + q) (g > 0);
    the anchor VALUES still come from the absolute chain recompute, so
    coefficient rounding only multiplies deltas.  Branch mismatches
    (d sign, b-form, degenerate) fall back to the direct difference."""
    ch0 = _rsoc_chain(ze0, zn0, zx0, lam)
    ze, zn, zx = ze0 + dze, zn0 + dzn, zx0 + dzx
    chc = _rsoc_chain(ze, zn, zx, lam)
    x1_0, x2_0, sc_0, pb0, bb0, dg0 = ch0
    x1_c, x2_c, sc_c, pbc, bbc, dgc = chc

    sum0 = ze0 + zn0
    sumc = ze + zn
    dsum = dze + dzn
    d0 = 2.0 * ze0 * zn0 - zx0
    dc_ = 2.0 * zn0 * dze + 2.0 * ze * dzn - dzx   # exact telescope
    d_c = d0 + dc_
    dg = dc_ / (2.0 * lam)
    g0 = d0 / (2.0 * lam)
    gc = d_c / (2.0 * lam)
    q0 = 4.0 * (ze0 * ze0 + zn0 * zn0 + zx0) / lam + 16.0
    dq = 4.0 * ((ze0 + ze) * dze + (zn0 + zn) * dzn + dzx) / lam
    qc = q0 + dq

    # --- w, negative-d branch: w = (N u) / E with N = 2 sum^2/lam,
    # u = 1/g_neg, E = 1 + 4u + sqrt(1 + q u^2)
    gn0 = jnp.where(g0 < 0, -g0, jnp.float32(1.0))
    gnc = jnp.where(gc < 0, -gc, jnp.float32(1.0))
    dgn = jnp.where((g0 < 0) & (gc < 0), -dg, gnc - gn0)
    u0 = 1.0 / gn0
    uc = 1.0 / gnc
    du = -dgn / (gn0 * gnc)
    N0 = 2.0 * sum0 * sum0 / lam
    dN = 2.0 * (sum0 + sumc) * dsum / lam
    h0 = jnp.sqrt(1.0 + q0 * u0 * u0)
    hc = jnp.sqrt(1.0 + qc * uc * uc)
    dh = (dq * uc * uc + q0 * (u0 + uc) * du) / (h0 + hc)
    E0 = 1.0 + 4.0 * u0 + h0
    Ec = 1.0 + 4.0 * uc + hc
    dE = 4.0 * du + dh
    Nu0 = N0 * u0
    dNu = dN * uc + N0 * du
    w_neg0 = Nu0 / E0
    dw_neg = (dNu - w_neg0 * dE) / Ec

    # --- w, positive-d branch: w = (g - 4 + sqrt(g^2 + q)) / 2
    gp0 = jnp.where(g0 > 0, g0, jnp.float32(1.0))
    gpc = jnp.where(gc > 0, gc, jnp.float32(1.0))
    dgp = jnp.where((g0 > 0) & (gc > 0), dg, gpc - gp0)
    S0 = jnp.sqrt(gp0 * gp0 + q0)
    Sc = jnp.sqrt(gpc * gpc + qc)
    dS = ((gp0 + gpc) * dgp + dq) / (S0 + Sc)
    dw_pos = (dgp + dS) / 2.0

    neg0 = d0 < 0
    negc = d_c < 0
    w_abs0 = jnp.where(neg0, w_neg0, (gp0 - 4.0 + S0) / 2.0)
    dw = jnp.where(neg0 & negc, dw_neg,
                   jnp.where((~neg0) & (~negc), dw_pos, jnp.nan))
    w_absc = jnp.where(negc, (2.0 * sumc * sumc / lam) / gnc
                       / (1.0 + 4.0 / gnc + hc),
                       (gpc - 4.0 + Sc) / 2.0)
    dw = jnp.where(jnp.isnan(dw), w_absc - w_abs0, dw)

    root0 = jnp.sqrt(jnp.maximum(w_abs0 * (w_abs0 + 4.0), 0.0))
    rootc = jnp.sqrt(jnp.maximum(w_absc * (w_absc + 4.0), 0.0))
    droot = (w_abs0 + w_absc + 4.0) * dw / (root0 + rootc + _TINY)

    def d_heads_std(s0_, sc_, ds_):
        den0 = s0_ * (s0_ + 2.0)
        denc = sc_ * (sc_ + 2.0)
        den0 = jnp.where(jnp.abs(den0) < _TINY, jnp.float32(_TINY), den0)
        denc = jnp.where(jnp.abs(denc) < _TINY, jnp.float32(_TINY), denc)
        dden = (s0_ + sc_ + 2.0) * ds_
        x10 = (ze0 * (s0_ + 1.0) ** 2 + zn0 * (s0_ + 1.0)) / den0
        x20 = (zn0 * (s0_ + 1.0) ** 2 + ze0 * (s0_ + 1.0)) / den0
        dsq = (s0_ + sc_ + 2.0) * ds_          # d (s+1)^2
        dN1 = (dze * (sc_ + 1.0) ** 2 + ze0 * dsq
               + dzn * (sc_ + 1.0) + zn0 * ds_)
        dN2 = (dzn * (sc_ + 1.0) ** 2 + zn0 * dsq
               + dze * (sc_ + 1.0) + ze0 * ds_)
        dx1 = (dN1 - x10 * dden) / denc
        dx2 = (dN2 - x20 * dden) / denc
        dscale = ds_ / ((sc_ + 2.0) * (s0_ + 2.0))
        return dx1, dx2, dscale

    def d_heads_b(s0_, sc_, ds_):
        den0 = (s0_ - 1.0) * (s0_ + 1.0)
        denc = (sc_ - 1.0) * (sc_ + 1.0)
        den0 = jnp.where(jnp.abs(den0) < _TINY, jnp.float32(_TINY), den0)
        denc = jnp.where(jnp.abs(denc) < _TINY, jnp.float32(_TINY), denc)
        dden = (s0_ + sc_) * ds_
        x10 = (ze0 * s0_ * s0_ + zn0 * s0_) / den0
        x20 = (zn0 * s0_ * s0_ + ze0 * s0_) / den0
        dsq = (s0_ + sc_) * ds_
        dN1 = dze * sc_ * sc_ + ze0 * dsq + dzn * sc_ + zn0 * ds_
        dN2 = dzn * sc_ * sc_ + zn0 * dsq + dze * sc_ + ze0 * ds_
        dx1 = (dN1 - x10 * dden) / denc
        dx2 = (dN2 - x20 * dden) / denc
        dscale = ds_ / ((sc_ + 1.0) * (s0_ + 1.0))
        return dx1, dx2, dscale

    # branch roots
    sa0 = (w_abs0 + root0) / 2.0
    sac = (w_absc + rootc) / 2.0
    dsa = (dw + droot) / 2.0
    sb0 = 2.0 / (w_abs0 + 2.0 + root0 + _TINY)
    sbc = 2.0 / (w_absc + 2.0 + rootc + _TINY)
    dsb = -2.0 * (dw + droot) / ((w_abs0 + 2.0 + root0 + _TINY)
                                 * (w_absc + 2.0 + rootc + _TINY))
    sc0_ = (w_abs0 - root0) / 2.0
    scc_ = (w_absc - rootc) / 2.0
    dsc_root = (dw - droot) / 2.0

    dxa = d_heads_std(sa0, sac, dsa)
    dxb = d_heads_b(sb0, sbc, dsb)
    dxc = d_heads_std(sc0_, scc_, dsc_root)
    same_pb = pb0 & pbc
    same_bb = bb0 & bbc
    same_cc = (~pb0) & (~pbc) & (~bb0) & (~bbc)
    dx1 = jnp.where(same_pb, dxa[0],
                    jnp.where(same_bb, dxb[0],
                              jnp.where(same_cc, dxc[0], jnp.nan)))
    dx2 = jnp.where(same_pb, dxa[1],
                    jnp.where(same_bb, dxb[1],
                              jnp.where(same_cc, dxc[1], jnp.nan)))
    dsc = jnp.where(same_pb, dxa[2],
                    jnp.where(same_bb, dxb[2],
                              jnp.where(same_cc, dxc[2], jnp.nan)))

    # degenerate branch (sum_zz == 0): x2 = (-ze + sqrt(ze^2+4lam+zx))/2
    T0 = jnp.sqrt(ze0 * ze0 + 4.0 * lam + zx0)
    Tc = jnp.sqrt(ze * ze + 4.0 * lam + zx)
    dT = ((ze0 + ze) * dze + dzx) / (T0 + Tc)
    dx2_deg = (-dze + dT) / 2.0
    both_deg = dg0 & dgc
    dx1 = jnp.where(both_deg, dx2_deg + dze, dx1)
    dx2 = jnp.where(both_deg, dx2_deg, dx2)
    dsc = jnp.where(both_deg, jnp.float32(0.0), dsc)

    # any remaining mismatch: direct difference of the chain outputs
    dx1 = jnp.where(jnp.isnan(dx1), x1_c - x1_0, dx1)
    dx2 = jnp.where(jnp.isnan(dx2), x2_c - x2_0, dx2)
    dsc = jnp.where(jnp.isnan(dsc), sc_c - sc_0, dsc)
    return dx1, dx2, dsc


def _cone_prox_delta(dtx, t0x, lam_x, cd: ConeKernelData):
    """P(dtx) = cone_prox(t0x + dtx) - cone_prox(t0x), per cone type.

    Orthant/SOC use stable delta chains; free is identity; zero-cone
    coordinates are masked off; RSOC heads use the direct difference
    (see _rsoc_delta).  P(0) == 0 structurally for the
    orthant/SOC paths and to f32 roundoff for the RSOC heads."""
    out = cd.mask_nn * _prox_nn_delta(dtx, t0x, lam_x) + cd.mask_free * dtx
    # block scalar anchors + deltas
    a0 = _dot_t(t0x, cd.Mh1)
    S20 = _dot_t(t0x, cd.Mh2)
    bsq0 = _dot_t(t0x * t0x, cd.Mb)
    da = _dot_t(dtx, cd.Mh1)
    dS2 = _dot_t(dtx, cd.Mh2)
    dbsq = _dot_t(2.0 * t0x * dtx + dtx * dtx, cd.Mb)
    de_soc, dsc_soc = _soc_delta(a0, bsq0, da, dbsq, lam_x)
    dr1, dr2, dsc_r = _rsoc_delta(a0, S20, bsq0, da, dS2, dbsq,
                                  lam_x)
    dh1 = jnp.where(cd.soc_blk > 0, de_soc, dr1)
    dsc = jnp.where(cd.soc_blk > 0, dsc_soc, dsc_r)
    # body: x_b = sc * t_b  ->  dx_b = sc0 * dt_b + dsc * (t0_b + dt_b)
    sc0_row = _dot(_sc0_of(a0, S20, bsq0, lam_x, cd), cd.Mb)
    dxb = (_dot(dh1, cd.Mh1) + _dot(dr2, cd.Mh2)
           + sc0_row * dtx + _dot(dsc, cd.Mb) * (t0x + dtx))
    return out + cd.mask_blk * dxb


def _sc0_of(a0, S20, bsq0, lam, cd):
    """Anchor body-scale row (f32 recompute; coefficients only)."""
    sc_soc = _soc_chain(a0, bsq0, lam)[9]
    sc_r = _rsoc_chain(a0, S20, bsq0, lam)[2]
    return jnp.where(cd.soc_blk > 0, sc_soc, sc_r)


class ConicDeltaAnchor(NamedTuple):
    """f32 operand set for one conic delta chunk ((1, k) rows)."""

    scal: jnp.ndarray     # (1, 128) packed scalars
    A: jnp.ndarray        # (m, n)
    Minv: jnp.ndarray     # Sinv (n, n) or Ginv (m, m) [woodbury]
    Hinv: jnp.ndarray     # (1, n) dual-form diagonal (zeros if primal)
    ry: jnp.ndarray       # (1, m) pre_calculate r-vector blocks
    rx: jnp.ndarray       # (1, n)
    b: jnp.ndarray        # (1, m)
    c: jnp.ndarray        # (1, n)
    Qd: jnp.ndarray       # (1, n) diagonal Q (zeros if none)
    cd: ConeKernelData
    t0x: jnp.ndarray      # prox argument anchor (f32 frame)
    etx: jnp.ndarray      # rounding residue of t0x
    e_y: jnp.ndarray      # y-update constant: rel_y0 - vy0 - y0
    e_x: jnp.ndarray      # cone_prox(t0x) - x0
    e_vx: jnp.ndarray     # x0 - rel_x0
    e_vy: jnp.ndarray     # y0 - rel_y0
    Qz0: jnp.ndarray      # Qd * zx0  (tau-quadratic c-coefficient)
    Qx0: jnp.ndarray      # Qd * x0   (inner-criterion N = x'Qx)
    e0y: jnp.ndarray      # (Qu_y - von_y)(anchor)
    e0x: jnp.ndarray      # (Qu_x - von_x)(anchor)
    Qu0y: jnp.ndarray     # Qu_y(anchor)   (norm cross-terms)
    Qu0x: jnp.ndarray
    von0y: jnp.ndarray    # rho_y * vy0
    von0x: jnp.ndarray    # rho_x * vx0


# scal slots
(_C_RHOY, _C_RHOX, _C_RHOT, _C_ACOEF, _C_LAM, _C_ALPHA, _C_THRESH,
 _C_QINIT, _C_B0, _C_C0, _C_S0, _C_TAU0, _C_KAP0, _C_T0T, _C_ETT,
 _C_ETAU, _C_EVTAU, _C_N0T, _C_E0T, _C_QU0T, _C_QN0, _C_VN0,
 _C_TAUT0) = range(23)


def _conic_delta_compute(anc: ConicDeltaAnchor, *, T, probe, woodbury):
    """Up to T conic DR delta iterations with the probe-granular
    inner-criterion stop.  Returns (dy, dx, dvy, dvx, out_row) with
    out_row (1, 128) = [dtau, dkappa, err, t_done]."""
    scal = anc.scal
    rho_y = scal[0, _C_RHOY]
    rho_x = scal[0, _C_RHOX]
    rho_tau = scal[0, _C_RHOT]
    a_coef = scal[0, _C_ACOEF]
    lam = scal[0, _C_LAM]
    alpha = scal[0, _C_ALPHA]
    thresh = scal[0, _C_THRESH]
    q_init = scal[0, _C_QINIT]
    b0s = scal[0, _C_B0]
    c0s = scal[0, _C_C0]
    s0s = scal[0, _C_S0]
    tau0 = scal[0, _C_TAU0]
    kap0 = scal[0, _C_KAP0]
    t0t = scal[0, _C_T0T]
    ett = scal[0, _C_ETT]
    etau = scal[0, _C_ETAU]
    evtau = scal[0, _C_EVTAU]
    N0_over_tau0 = scal[0, _C_N0T]
    e0t = scal[0, _C_E0T]
    Qu0t = scal[0, _C_QU0T]
    qn0 = scal[0, _C_QN0]
    vn0 = scal[0, _C_VN0]
    inv_ry = 1.0 / rho_y
    lam_x = lam / rho_x
    lam_tau = lam / rho_tau
    A = anc.A

    def solve_S(rhs):
        if woodbury:
            t = anc.Hinv * rhs
            u = _dot_t(_dot_t(t, A), anc.Minv)
            return t - anc.Hinv * _dot(u, A)
        return _dot(rhs, anc.Minv)

    def iter_body(_, carry):
        dy, dx, dvy, dvx, dtau, dkap = carry
        dwy = rho_y * (dy + dvy)
        dwx = rho_x * (dx + dvx)
        deta = rho_tau * (dtau + dkap)
        drhs = dwx + inv_ry * _dot(dwy, A)
        dzx = solve_S(drhs)
        dzy = inv_ry * (dwy - _dot_t(dzx, A))
        db = (jnp.sum(anc.ry * dwy) + jnp.sum(anc.rx * dwx)
              - 2.0 * (rho_y * jnp.sum(anc.ry * dzy)
                       + rho_x * jnp.sum(anc.rx * dzx)) - deta)
        dc = -(2.0 * jnp.sum(anc.Qz0 * dzx)
               + jnp.sum(dzx * anc.Qd * dzx))
        bc = b0s + db
        cc = c0s + dc
        s_cur = jnp.sqrt(jnp.maximum(bc * bc - 4.0 * a_coef * cc, 0.0))
        ds = ((b0s + bc) * db - 4.0 * a_coef * dc) / (s_cur + s0s + _TINY)
        dtau_t = (-db + ds) / (2.0 * a_coef)
        duty = dzy - dtau_t * anc.ry
        dutx = dzx - dtau_t * anc.rx
        drel_y = alpha * duty + (1.0 - alpha) * dy
        drel_x = alpha * dutx + (1.0 - alpha) * dx
        drel_t = alpha * dtau_t + (1.0 - alpha) * dtau
        dty = drel_y - dvy
        dtx = drel_x - dvx + anc.etx
        dtt = drel_t - dkap + ett
        dy_n = anc.e_y + dty
        dx_n = anc.e_x + _cone_prox_delta(dtx, anc.t0x, lam_x, anc.cd)
        dtau_n = etau + _prox_nn_delta(dtt, t0t, lam_tau)
        dvy_n = dvy + dy_n - drel_y + anc.e_vy
        dvx_n = dvx + dx_n - drel_x + anc.e_vx
        dkap_n = dkap + dtau_n - drel_t + evtau
        return (dy_n, dx_n, dvy_n, dvx_n, dtau_n, dkap_n)

    def err_delta(dy, dx, dvy, dvx, dtau, dkap):
        dQy = _dot_t(dx, A) - anc.b * dtau
        dQx = anc.Qd * dx - _dot(dy, A) + anc.c * dtau
        # N = x'Qx; Qu_tau = -N/tau + y.b - x.c
        dN = 2.0 * jnp.sum(anc.Qx0 * dx) + jnp.sum(dx * anc.Qd * dx)
        tau = tau0 + dtau
        tau_safe = jnp.where(jnp.abs(tau) < _EPS_TAU,
                             jnp.float32(_EPS_TAU), tau)
        dQt = (-(dN - N0_over_tau0 * dtau) / tau_safe
               + jnp.sum(dy * anc.b) - jnp.sum(dx * anc.c))
        dvony = rho_y * dvy
        dvonx = rho_x * dvx
        dvont = rho_tau * dkap
        r1 = anc.e0y + dQy - dvony
        r2 = anc.e0x + dQx - dvonx
        r3 = e0t + dQt - dvont
        d2 = jnp.sum(r1 * r1) + jnp.sum(r2 * r2) + r3 * r3
        qn = jnp.sqrt(jnp.maximum(
            qn0 * qn0 + 2.0 * (jnp.sum(anc.Qu0y * dQy)
                               + jnp.sum(anc.Qu0x * dQx) + Qu0t * dQt)
            + jnp.sum(dQy * dQy) + jnp.sum(dQx * dQx) + dQt * dQt, 0.0))
        vn = jnp.sqrt(jnp.maximum(
            vn0 * vn0 + 2.0 * (jnp.sum(anc.von0y * dvony)
                               + jnp.sum(anc.von0x * dvonx)
                               + rho_tau * kap0 * dvont)
            + jnp.sum(dvony * dvony) + jnp.sum(dvonx * dvonx)
            + dvont * dvont, 0.0))
        return jnp.sqrt(jnp.maximum(d2, 0.0)) / (1.0 + qn + vn)

    def trip_cond(cry):
        return jnp.logical_and(cry[0] < T, cry[1] >= thresh)

    def trip_body(cry):
        t, _e, dy, dx, dvy, dvx, dtau, dkap = cry
        dy, dx, dvy, dvx, dtau, dkap = jax.lax.fori_loop(
            0, probe, iter_body, (dy, dx, dvy, dvx, dtau, dkap))
        e = err_delta(dy, dx, dvy, dvx, dtau, dkap)
        return (t + probe, e, dy, dx, dvy, dvx, dtau, dkap)

    zy = jnp.zeros_like(anc.e_y)
    zx = jnp.zeros_like(anc.e_x)
    zs = jnp.zeros((), f32)
    t, e, dy, dx, dvy, dvx, dtau, dkap = jax.lax.while_loop(
        trip_cond, trip_body,
        (jnp.zeros((), jnp.int32), q_init, zy, zx, zy, zx, zs, zs))
    col = jax.lax.broadcasted_iota(jnp.int32, (1, 128), 1)
    out = jnp.where(col == 0, dtau, 0.0)
    out = out + jnp.where(col == 1, dkap, 0.0)
    out = out + jnp.where(col == 2, e, 0.0)
    out = out + jnp.where(col == 3, t.astype(f32), 0.0)
    return dy, dx, dvy, dvx, out.astype(f32)


def conic_delta_anchor(A64, solve_fn, Qd64, ry64, rx64, b64, c64,
                       a_coef, rho_y, rho_x, rho_tau, lam, alpha,
                       thresh, u, v, q_init, layout, cd,
                       A32, Minv32, Hinv32, woodbury
                       ) -> ConicDeltaAnchor:
    """Build the f32 operand set of one conic delta chunk (traced f64
    code, once per chunk).  solve_fn(w_y, w_x) must be the f64-quality
    DR linear solve (`DenseSchurSolver.solve` signature); the anchor
    images replicate one absolute DR iteration (`source/abip.c:186-314`)
    at the exact entry state.

    NOTE: the first-ever DR iteration's `tau_t := 1` special case
    (`k0 + i == 0`) is NOT represented -- this engine is an ENDGAME
    (entered after the sprint phase, k > 0 always)."""
    m, n = A64.shape
    y0 = u[:m]
    x0 = u[m:m + n]
    tau0 = u[m + n]
    vy0 = v[:m]
    vx0 = v[m:m + n]
    kap0 = v[m + n]
    lam_x = lam / rho_x
    lam_tau = lam / rho_tau

    wy0 = rho_y * (y0 + vy0)
    wx0 = rho_x * (x0 + vx0)
    eta0 = rho_tau * (tau0 + kap0)
    zy0, zx0, _ = solve_fn(wy0, wx0, -1, None)
    Qd_ = jnp.zeros((n,), f64) if Qd64 is None else Qd64
    b0 = (jnp.dot(ry64, wy0) + jnp.dot(rx64, wx0)
          - 2.0 * (rho_y * jnp.dot(ry64, zy0)
                   + rho_x * jnp.dot(rx64, zx0)) - eta0)
    c0 = -jnp.dot(zx0, Qd_ * zx0)
    s0 = jnp.sqrt(jnp.maximum(b0 * b0 - 4.0 * a_coef * c0, 0.0))
    tau_t0 = (-b0 + s0) / (2.0 * a_coef)
    uty0 = zy0 - tau_t0 * ry64
    utx0 = zx0 - tau_t0 * rx64
    rel_y0 = alpha * uty0 + (1.0 - alpha) * y0
    rel_x0 = alpha * utx0 + (1.0 - alpha) * x0
    rel_t0 = alpha * tau_t0 + (1.0 - alpha) * tau0
    e_y = rel_y0 - vy0 - y0
    t0x_32 = (rel_x0 - vx0).astype(f32)
    etx = (rel_x0 - vx0) - t0x_32.astype(f64)
    from ..cones import cone_barrier_prox

    x_a = cone_barrier_prox(t0x_32.astype(f64),
                            jnp.full((n,), 1.0, f64) * lam_x, layout)
    e_x = x_a - x0
    e_vx = x0 - rel_x0
    e_vy = y0 - rel_y0
    t0t_32 = (rel_t0 - kap0).astype(f32)
    ett = (rel_t0 - kap0) - t0t_32.astype(f64)
    t0t64 = t0t_32.astype(f64)
    sat = jnp.sqrt(t0t64 * t0t64 + 4.0 * lam_tau)
    tau_a = jnp.where(t0t64 >= 0, 0.5 * (t0t64 + sat),
                      2.0 * lam_tau / (sat - t0t64))
    etau = tau_a - tau0
    evtau = tau0 - rel_t0

    # inner-criterion anchors (`qcp_config.c:518-557`)
    Mu_y0 = A64 @ x0
    Mu_x0 = Qd_ * x0 - A64.T @ y0
    Qu_y0 = Mu_y0 - b64 * tau0
    Qu_x0 = Mu_x0 + c64 * tau0
    N0 = jnp.dot(x0, Qd_ * x0)
    tau_safe0 = jnp.where(jnp.abs(tau0) < _EPS_TAU, _EPS_TAU, tau0)
    Qu_t0 = (-N0 / tau_safe0 + jnp.dot(y0, b64) - jnp.dot(x0, c64))
    von_y0 = rho_y * vy0
    von_x0 = rho_x * vx0
    von_t0 = rho_tau * kap0
    e0y = Qu_y0 - von_y0
    e0x = Qu_x0 - von_x0
    e0t = Qu_t0 - von_t0
    qn0 = jnp.sqrt(jnp.dot(Qu_y0, Qu_y0) + jnp.dot(Qu_x0, Qu_x0)
                   + Qu_t0 * Qu_t0)
    vn0 = jnp.sqrt(jnp.dot(von_y0, von_y0) + jnp.dot(von_x0, von_x0)
                   + von_t0 * von_t0)

    scal_vals = [rho_y, rho_x, rho_tau, a_coef, lam, alpha, thresh,
                 q_init, b0, c0, s0, tau0, kap0, t0t_32.astype(f64),
                 ett, etau, evtau, N0 / tau_safe0, e0t, Qu_t0, qn0, vn0,
                 tau_t0]
    col = jax.lax.broadcasted_iota(jnp.int32, (1, 128), 1)
    scal = jnp.zeros((1, 128), f32)
    for i, sv in enumerate(scal_vals):
        scal = scal + jnp.where(col == i,
                                jnp.asarray(sv, f64).astype(f32), 0.0)

    return ConicDeltaAnchor(
        scal=scal, A=A32, Minv=Minv32, Hinv=_row(Hinv32),
        ry=_row(ry64), rx=_row(rx64), b=_row(b64), c=_row(c64),
        Qd=_row(Qd_), cd=cd, t0x=_row(t0x_32), etx=_row(etx),
        e_y=_row(e_y), e_x=_row(e_x), e_vx=_row(e_vx), e_vy=_row(e_vy),
        Qz0=_row(Qd_ * zx0), Qx0=_row(Qd_ * x0), e0y=_row(e0y),
        e0x=_row(e0x), Qu0y=_row(Qu_y0), Qu0x=_row(Qu_x0),
        von0y=_row(von_y0), von0x=_row(von_x0))


class ConicDeltaResult(NamedTuple):
    u: jnp.ndarray
    v: jnp.ndarray
    t_done: jnp.ndarray
    err: jnp.ndarray


def run_conic_delta_chunk(A64, solve_fn, Qd64, ry64, rx64, b64, c64,
                          a_coef, rho_y, rho_x, rho_tau, lam, alpha,
                          thresh, u, v, q_init, layout, cd,
                          A32, Minv32, Hinv32, woodbury, *, T, probe
                          ) -> ConicDeltaResult:
    """One anchored-delta conic chunk (plain XLA, HIGHEST-precision f32
    products); vmap-able."""
    m, n = A64.shape
    anc = conic_delta_anchor(A64, solve_fn, Qd64, ry64, rx64, b64, c64,
                             a_coef, rho_y, rho_x, rho_tau, lam, alpha,
                             thresh, u, v, q_init, layout, cd,
                             A32, Minv32, Hinv32, woodbury)
    with jax.default_matmul_precision("highest"):
        dy, dx, dvy, dvx, row = _conic_delta_compute(
            anc, T=T, probe=probe, woodbury=woodbury)
    dtau = row[0, 0].astype(f64)
    dkap = row[0, 1].astype(f64)
    err = row[0, 2].astype(f64)
    t_done = row[0, 3].astype(jnp.int32)
    u_new = jnp.concatenate([
        u[:m] + dy[0].astype(f64),
        u[m:m + n] + dx[0].astype(f64),
        (u[m + n] + dtau)[None]])
    v_new = jnp.concatenate([
        v[:m] + dvy[0].astype(f64),
        v[m:m + n] + dvx[0].astype(f64),
        (v[m + n] + dkap)[None]])
    return ConicDeltaResult(u=u_new, v=v_new, t_done=t_done, err=err)
