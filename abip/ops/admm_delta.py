"""Anchored-delta ADMM chunk: f64-quality iterates from f32 arithmetic.

The accuracy endgame (mu below ~1e-4 down to eps) needs f64-quality
iterates: f32 resolution on O(1) iterates is ~6e-8, so a pure-f32 ADMM
loop cannot reach eps=1e-6.  The chunk iterates DELTAS from an f64 anchor
entirely in f32: every quantity the kernel touches is small (the
distance from the chunk-entry iterate), so f32's ~1e-7 RELATIVE error
is ~1e-7*||delta|| ABSOLUTE error -- far below the f64 iterate's own
movement.  The recurrence is exact in the delta frame:

  absolute:  (y,x,vx,tau,kappa) -> F(y,x,vx,tau,kappa)   [admm step]
  delta:     d -> F(anchor + d) - anchor
           = E + L(d) + prox-delta terms

where the constant E := F(anchor) - anchor (the fixed-point residual of
the anchor, O(qres) ~ 1e-4..1e-8, tiny in f32 absolute terms) and the
anchor images are computed ONCE per chunk in f64 OUTSIDE the kernel
(`delta_anchor`: one cached-factor projection + prox evals, ~2 steps-
iterations of f64 work amortized over up to T=768 kernel iterations).

Numerical hygiene (each is load-bearing; see `_delta_compute`):

* The anchor frame is the EXACT f64 entry state: the anchor values
  enter the kernel recurrence only through their f64-computed images
  (E-terms, qres anchors) and benign norm cross-terms, so no rounding
  of the frame is needed.
* The barrier prox delta uses the cancellation-free identity
  prox(t) = (t + s)/2 = 2*lam/(s - t),  s = sqrt(t^2 + 4 lam),
  giving  p(dt) := prox(t0+dt) - prox(t0)  via
  ds = dt*(2 t0 + dt)/(s + s0)  (positive branch: p = (dt+ds)/2;
  negative branch: p = 2 lam (dt-ds) / ((s-t)(s0-t0)) ) -- every factor
  is accurate RELATIVE to the delta, never differenced at O(1) scale.
* t0 is rounded to f32 and the rounding residue is folded into a
  per-coordinate offset et := (rel_x0 - vx0) - f32(t0), so the prox
  argument the kernel reconstructs equals the true one to O(1e-14).
* The in-kernel inner-criterion probe (`abip.c:2131-2173`) is evaluated
  in the same delta frame: q1/q2/q3 anchors are f64-computed residuals
  (small), deltas are linear -- the probe resolves qres down to
  ~1e-7*||delta||, enough for eps=1e-8 endgames.
* The stage-average candidate (`compute_avg`, `abip.c:635-659`) is
  tracked in-kernel as delta sums; prior-chunk history enters through
  c0 := S_prev - sj_prev*anchor, so the averaged-iterate criterion that
  kills degenerate-lane cycling (650080d) survives chunk boundaries.

The chunk runs either as ONE Triton kernel (Pallas, `backend="triton"`)
on the GPU -- one program per lane, the whole T-iteration loop inside
the kernel, every lane stopping within probe-1 iterations of ITS OWN
criterion (a converged lane runs zero trips: the q carry starts at the
entry qres) -- or as the identical-math XLA reference `_delta_ref`
elsewhere.  Both evaluate the same `_delta_compute`; only the three
matrix applies differ.  The kernel streams A and Ninv in (bm, 2^k)
row tiles with masked loads, so no operand is padded in memory, and
every product is an f32 multiply-and-reduce (true f32, never TF32).

Reference hot loop: `src/abip-lp/src/abip.c:2131-2215` (projection
:539, barrier prox :717, dual update :567, inner stop :1951-2051).
"""
from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

f32 = jnp.float32
f64 = jnp.float64
_HI = jax.lax.Precision.HIGHEST


class DeltaAnchor(NamedTuple):
    """f32 operands of one delta chunk, unpadded: (m,) y-block and (n,)
    x-block vectors (see the module docstring for the role of each)."""

    scal: jnp.ndarray     # (19,) packed scalars, slots below
    A: jnp.ndarray        # (m, n)
    Ninv: jnp.ndarray     # (m, m)
    hy: jnp.ndarray
    hx: jnp.ndarray
    gy: jnp.ndarray
    gx: jnp.ndarray
    ey: jnp.ndarray       # F(anchor)-anchor, y block
    ex: jnp.ndarray       # prox(t0)-x0
    evx: jnp.ndarray      # x0 - rel_x0
    t0x: jnp.ndarray      # f32 prox-argument anchor
    sax: jnp.ndarray      # sqrt(t0x^2 + 4 lam), f64-computed from f32 t0x
    etx: jnp.ndarray      # (rel_x0 - vx0) - t0x rounding residue
    q1_0: jnp.ndarray     # (m,) qres anchor: A x0 + tau0 hy
    q2_0: jnp.ndarray     # (n,) qres anchor: A'y0 + vx0 - tau0 hx
    y0: jnp.ndarray       # anchor values (norm cross-terms)
    x0: jnp.ndarray
    vx0: jnp.ndarray
    c0y: jnp.ndarray      # prior-chunk average history: S_prev - sj*anchor
    c0x: jnp.ndarray
    c0vx: jnp.ndarray


_Y_FIELDS = frozenset(("hy", "gy", "ey", "q1_0", "y0", "c0y"))

# scal slots
(_S_RHOY, _S_IGTH, _S_LAM, _S_ALPHA, _S_THRESH, _S_TAU0, _S_KAPPA0,
 _S_T0T, _S_SAT, _S_ETT, _S_ETAU, _S_EVTAU, _S_Q30, _S_UN0, _S_VN0,
 _S_SJ, _S_C0TAU, _S_C0KAP, _S_QINIT) = range(19)
_NROW = 8   # output row: dtau, dkappa, dstau, dskappa, qres, t_done, avg


def _prox_delta(dt, t0, s0, lam):
    """prox(t0 + dt, lam) - prox(t0, lam), cancellation-free.

    s0 = sqrt(t0^2 + 4 lam) must be consistent with t0 (computed in f64
    from the f32 t0).  Both branch formulas are algebraic identities of
    prox (see module docstring); the branch is chosen by the CURRENT
    argument's sign for conditioning.  lam > 0 keeps every denominator
    >= 2*sqrt(lam) > 0."""
    t = t0 + dt
    s = jnp.sqrt(t * t + 4.0 * lam)        # rel-accurate; used in sums only
    ds = dt * (t0 + t) / (s + s0)
    pos = 0.5 * (dt + ds)
    neg = 2.0 * lam * (dt - ds) / ((s - t) * (s0 - t0))
    return jnp.where(t >= 0, pos, neg)


class _Ops(NamedTuple):
    """What `_delta_compute` needs from its host: operand access and the
    three matrix applies.  The XLA reference and the kernel differ only
    here."""

    vec: Callable        # DeltaAnchor field name -> vector
    scal: Callable       # scal slot -> scalar
    Av: Callable         # v -> A v
    Atw: Callable        # w -> A' w
    NAtw: Callable       # r -> (Ninv r, A' Ninv r)
    maskx: Callable      # zero the x coordinates past n (kernel padding)
    zy: jnp.ndarray      # zero y-block vector
    zx: jnp.ndarray      # zero x-block vector


def _delta_compute(ops: _Ops, *, T, probe):
    """Up to T delta iterations with a probe-granular in-loop stop.

    Returns (dy, dx, dvx, dsy, dsx, dsvx, row): final deltas, delta
    sums over executed iterations, and an (_NROW,) f32 row packing
    [dtau, dkappa, dstau, dskappa, qres, t_done, avg_crit]."""
    S, V = ops.scal, ops.vec
    rho_y = S(_S_RHOY)
    inv_gth1 = S(_S_IGTH)
    lam = S(_S_LAM)
    alpha = S(_S_ALPHA)
    thresh = S(_S_THRESH)
    tau0 = S(_S_TAU0)
    kappa0 = S(_S_KAPPA0)
    t0t = S(_S_T0T)
    sat = S(_S_SAT)
    ett = S(_S_ETT)
    etau = S(_S_ETAU)
    evtau = S(_S_EVTAU)
    q3_0 = S(_S_Q30)
    un0 = S(_S_UN0)
    vn0 = S(_S_VN0)
    sj_prev = S(_S_SJ)
    c0tau = S(_S_C0TAU)
    c0kap = S(_S_C0KAP)
    q_init = S(_S_QINIT)

    def iter_body(_, carry):
        dy, dx, dvx, dtau, dkap, dsy, dsx, dsvx, dstau, dskap = carry
        hy, hx = V("hy"), V("hx")
        # linear projection pipeline on deltas (exact: same operators)
        drtau = dtau + dkap
        dqy = rho_y * dy - drtau * hy
        dqx = (dx + dvx) - drtau * hx
        dcoef = (jnp.sum(dqy * V("gy")) + jnp.sum(dqx * V("gx"))) * inv_gth1
        dqy = dqy - dcoef * hy
        dqx = dqx - dcoef * hx
        dwx = -dqx
        dz_y, dATz = ops.NAtw(dqy + ops.Av(dwx))
        dz_x = dATz - dwx
        dtau_t = drtau + jnp.sum(dz_y * hy) + jnp.sum(dz_x * hx)
        # y update: y+ = z_y - vy  ->  dy+ = ey + dz_y
        dy_n = V("ey") + dz_y
        # prox arguments: t = t0 + (drel - dv + et)
        drel_x = alpha * dz_x + (1.0 - alpha) * dx
        dtx = drel_x - dvx + V("etx")
        px = ops.maskx(_prox_delta(dtx, V("t0x"), V("sax"), lam))
        dx_n = V("ex") + px
        dvx_n = dvx + dx_n - drel_x + V("evx")
        drel_t = alpha * dtau_t + (1.0 - alpha) * dtau
        dtt = drel_t - dkap + ett
        pt = _prox_delta(dtt, t0t, sat, lam)
        dtau_n = etau + pt
        dkap_n = dkap + dtau_n - drel_t + evtau
        return (dy_n, dx_n, dvx_n, dtau_n, dkap_n,
                dsy + dy_n, dsx + dx_n, dsvx + dvx_n,
                dstau + dtau_n, dskap + dkap_n)

    def qres_delta(dy, dx, dvx, dtau, dkap):
        """HSD-operator residual at anchor + delta (`abip.c:1951-1996`
        in the delta frame; h = (-b; c))."""
        hy, hx = V("hy"), V("hx")
        q1 = V("q1_0") + ops.Av(dx) + dtau * hy
        q2 = V("q2_0") + ops.Atw(dy) + dvx - dtau * hx
        q3 = q3_0 - jnp.sum(dy * hy) - jnp.sum(dx * hx) - dkap
        qsq = jnp.sum(q1 * q1) + jnp.sum(q2 * q2) + q3 * q3
        un = (un0 + 2.0 * (jnp.sum(V("y0") * dy) + jnp.sum(V("x0") * dx)
                           + tau0 * dtau)
              + jnp.sum(dy * dy) + jnp.sum(dx * dx) + dtau * dtau)
        vn = (vn0 + 2.0 * (jnp.sum(V("vx0") * dvx) + kappa0 * dkap)
              + jnp.sum(dvx * dvx) + dkap * dkap)
        denom = 1.0 + jnp.sqrt(jnp.maximum(un + vn, 0.0))
        return jnp.sqrt(qsq) / denom

    def trip_cond(c):
        return jnp.logical_and(c[0] < T, c[1] >= thresh)

    def trip_body(c):
        t, _q, _ac, dy, dx, dvx, dtau, dkap, dsy, dsx, dsvx, dstau, dskap = c
        (dy, dx, dvx, dtau, dkap, dsy, dsx, dsvx, dstau, dskap) = \
            jax.lax.fori_loop(0, probe, iter_body,
                              (dy, dx, dvx, dtau, dkap,
                               dsy, dsx, dsvx, dstau, dskap))
        k = (t + probe).astype(dt)
        dom = jnp.maximum(sj_prev + k, 1.0)
        q_cur = qres_delta(dy, dx, dvx, dtau, dkap)
        q_avg = qres_delta((V("c0y") + dsy) / dom, (V("c0x") + dsx) / dom,
                           (V("c0vx") + dsvx) / dom, (c0tau + dstau) / dom,
                           (c0kap + dskap) / dom)
        avg_crit = (q_avg < q_cur).astype(dt)
        q = jnp.minimum(q_avg, q_cur)
        return (t + probe, q, avg_crit, dy, dx, dvx, dtau, dkap,
                dsy, dsx, dsvx, dstau, dskap)

    zy, zx = ops.zy, ops.zx
    dt = zy.dtype
    zs = jnp.zeros((), dt)
    (t, q, avg_crit, dy, dx, dvx, dtau, dkap,
     dsy, dsx, dsvx, dstau, dskap) = jax.lax.while_loop(
        trip_cond, trip_body,
        (jnp.zeros((), jnp.int32), q_init, zs, zy, zx, zx, zs, zs,
         zy, zx, zx, zs, zs))
    col = jax.lax.broadcasted_iota(jnp.int32, (_NROW,), 0)
    row = jnp.zeros((_NROW,), dt)
    for i, val in enumerate((dtau, dkap, dstau, dskap, q,
                             t.astype(dt), avg_crit)):
        row = row + jnp.where(col == i, val, 0.0)
    return dy, dx, dvx, dsy, dsx, dsvx, row


def _delta_ref(anchor: DeltaAnchor, T, probe):
    """Plain-XLA delta chunk (HIGHEST-precision f32 products): the
    compute path off the GPU and the oracle for the kernel."""
    A, Ninv = anchor.A, anchor.Ninv
    m, n = A.shape

    def Atw(w):
        return jnp.matmul(w, A, precision=_HI)

    def NAtw(r):
        z = jnp.matmul(Ninv, r, precision=_HI)
        return z, Atw(z)

    ops = _Ops(vec=partial(getattr, anchor), scal=lambda i: anchor.scal[i],
               Av=lambda v: jnp.matmul(A, v, precision=_HI), Atw=Atw,
               NAtw=NAtw, maskx=lambda x: x,
               zy=jnp.zeros((m,), A.dtype), zx=jnp.zeros((n,), A.dtype))
    return _delta_compute(ops, T=T, probe=probe)


def _pow2(k):
    return 1 << max(0, int(k) - 1).bit_length()


def kernel_config(m, n):
    """Block shapes of the kernel for an (m, n) lane: vectors live in
    registers as (MP,) / (NP,) power-of-two blocks, and A / Ninv stream
    through (bm, NP) / (bm, MP) row tiles of ~64 f32 registers a thread.
    Each row tile costs a cross-thread reduction, so the tiles are as
    tall as the registers allow (measured on the H100 at m=50, n=2000,
    B=16, 8 warps: 21.2 us per iteration at bm=8, 22.8 at bm=4, 31.5 at
    bm=2).
    Returns (MP, NP, bm, num_warps)."""
    MP, NP = _pow2(m), _pow2(n)
    num_warps = 4 if NP <= 1024 else 8 if NP <= 4096 else 16
    bm = max(1, min(MP, 64 * 32 * num_warps // NP))
    return MP, NP, bm, num_warps


def _delta_kernel(*refs, m, n, MP, NP, bm, T, probe):
    """One lane's delta chunk (one Triton program; grid over lanes comes
    from `vmap`).  Rows and columns past (m, n) are masked on load, so
    every padded register coordinate holds 0 and stays 0."""
    nin = len(DeltaAnchor._fields)
    ins = dict(zip(DeltaAnchor._fields, refs[:nin]))
    outs = refs[nin:]
    A_ref, N_ref, s_ref = ins["A"], ins["Ninv"], ins["scal"]
    iy = jax.lax.broadcasted_iota(jnp.int32, (MP,), 0)
    ix = jax.lax.broadcasted_iota(jnp.int32, (NP,), 0)
    my, mx = iy < m, ix < n
    r0 = jax.lax.broadcasted_iota(jnp.int32, (bm,), 0)
    ntiles = jnp.int32(pl.cdiv(m, bm))

    def vec(name):
        if name in _Y_FIELDS:
            return plgpu.load(ins[name].at[pl.ds(0, MP)], mask=my, other=0.0)
        return plgpu.load(ins[name].at[pl.ds(0, NP)], mask=mx, other=0.0)

    def tile(ref, r, width, cmask):
        rows = r * bm + r0
        t = plgpu.load(ref.at[pl.ds(r * bm, bm), pl.ds(0, width)],
                       mask=(rows[:, None] < m) & cmask[None, :], other=0.0)
        return rows, t

    def onehot(rows):          # (bm, MP): tile row i <-> y coordinate
        return iy[None, :] == rows[:, None]

    def place(rows, part):     # (bm,) tile values -> (MP,) y vector
        return jnp.sum(jnp.where(onehot(rows), part[:, None], 0.0), axis=0)

    def Av(v):
        def body(r, acc):
            rows, t = tile(A_ref, r, NP, mx)
            return acc + place(rows, jnp.sum(t * v[None, :], axis=1))
        return jax.lax.fori_loop(jnp.int32(0), ntiles, body,
                                 jnp.zeros((MP,), f32))

    def Atw(w):
        def body(r, acc):
            rows, t = tile(A_ref, r, NP, mx)
            wt = jnp.sum(jnp.where(onehot(rows), w[None, :], 0.0), axis=1)
            return acc + jnp.sum(t * wt[:, None], axis=0)
        return jax.lax.fori_loop(jnp.int32(0), ntiles, body,
                                 jnp.zeros((NP,), f32))

    def NAtw(rv):
        # one pass: each Ninv row tile yields its z rows, which feed the
        # same A row tile's contribution to A'z
        def body(r, c):
            z, acc = c
            rows, nt = tile(N_ref, r, MP, my)
            zt = jnp.sum(nt * rv[None, :], axis=1)
            _, at = tile(A_ref, r, NP, mx)
            return z + place(rows, zt), acc + jnp.sum(at * zt[:, None], axis=0)
        return jax.lax.fori_loop(
            jnp.int32(0), ntiles, body,
            (jnp.zeros((MP,), f32), jnp.zeros((NP,), f32)))

    ops = _Ops(vec=vec, scal=lambda i: s_ref[i], Av=Av, Atw=Atw, NAtw=NAtw,
               maskx=lambda x: jnp.where(mx, x, 0.0),
               zy=jnp.zeros((MP,), f32), zx=jnp.zeros((NP,), f32))
    res = _delta_compute(ops, T=T, probe=probe)
    for ref, val in zip(outs[:6], res[:6]):
        if val.shape[0] == MP:
            plgpu.store(ref.at[pl.ds(0, MP)], val, mask=my)
        else:
            plgpu.store(ref.at[pl.ds(0, NP)], val, mask=mx)
    outs[6][...] = res[6]


def _delta_kernel_call(anchor: DeltaAnchor, T, probe, interpret=False):
    """The delta chunk as one Triton kernel; `jax.vmap` over lanes turns
    it into a grid of one program per lane."""
    m, n = anchor.A.shape
    MP, NP, bm, num_warps = kernel_config(m, n)
    ys = jax.ShapeDtypeStruct((m,), f32)
    xs = jax.ShapeDtypeStruct((n,), f32)
    return pl.pallas_call(
        partial(_delta_kernel, m=m, n=n, MP=MP, NP=NP, bm=bm, T=T,
                probe=probe),
        out_shape=(ys, xs, xs, ys, xs, xs,
                   jax.ShapeDtypeStruct((_NROW,), f32)),
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        backend="triton", interpret=interpret, name="abip_delta_chunk",
    )(*anchor)


# What the kernel takes.  One program per lane walks A and Ninv in
# cdiv(m, bm) row-tile trips per matrix pass, and each trip costs about
# 2-3 us of a chunk iteration whatever the column block, while XLA's
# batched chunk sits near a launch-bound 27-33 us per iteration
# (`tools/delta_sweep.py` on the H100, B=16: 7-10 trips win or tie,
# 13-25 trips lose but for one narrow lane; 125 trips at m=500 x n=5000
# lose 14x).  Larger batches only widen the kernel's lead (B=128 at
# m=50 x n=2000: 40 vs 93 us), as XLA's time grows with B and the
# kernel's does not until the lanes outnumber the SMs.
KERNEL_MAX_TRIPS = 10
KERNEL_MAX_NP = 8192   # widest column block measured (16 warps)


def use_kernel(m, n) -> bool:
    """The delta chunk runs as the Triton kernel when JAX's default
    backend is the GPU and one program covers the lane in at most
    `KERNEL_MAX_TRIPS` row-tile trips, with register blocks no wider
    than measured (and Ninv's no wider than A's: m <= n)."""
    MP, NP, bm, _ = kernel_config(m, n)
    return (jax.default_backend() == "gpu"
            and pl.cdiv(m, bm) <= KERNEL_MAX_TRIPS
            and MP <= NP <= KERNEL_MAX_NP)


def delta_anchor(A64, solve64, h, g, g_th, rho_y, lam, alpha, thresh,
                 u, v, u_sum, v_sum, sj, qres, A32=None,
                 Ninv32=None) -> DeltaAnchor:
    """Build the f32 operand set of one delta chunk from the f64 entry
    state.  The anchor frame is the EXACT f64 entry state (the anchor
    values enter the kernel recurrence only through f64-computed images;
    the one cancellation-sensitive anchor VALUE, the prox argument t0,
    is f32-rounded with its residue folded into the et offset -- module
    docstring).  Traced code: runs inside the jitted driver, once per
    chunk.

    solve64(rhs) must apply (rho_y I + A A')^-1 in f64 (cached factor).
    u_sum/v_sum/sj: stage-average accumulators (f64) BEFORE this chunk;
    qres: entry inner-criterion value (so an already-converged lane runs
    zero kernel trips).  A32/Ninv32: optionally precomputed f32 operator
    blocks (loop-invariant -- pass them to keep the per-chunk anchor
    cost at ~2 f64 iterations)."""
    m, n = A64.shape
    hy64, hx64 = h[:m], h[m:m + n]
    y0 = u[:m]
    x0 = u[m:m + n]
    tau0 = u[m + n]
    vy0 = v[:m]
    vx0 = v[m:m + n]
    kap0 = v[m + n]
    # one absolute ADMM step at the anchor, in f64 (`abip.c:539-584`)
    r_y = y0 + vy0
    r_x = x0 + vx0
    r_t = tau0 + kap0
    qy = rho_y * r_y - r_t * hy64
    qx = r_x - r_t * hx64
    coef = (jnp.dot(qy, g[:m]) + jnp.dot(qx, g[m:m + n])) / (g_th + 1.0)
    qy = qy - coef * hy64
    qx = qx - coef * hx64
    wx = -qx
    rhs = qy + A64 @ wx
    z_y = solve64(rhs)
    z_x = A64.T @ z_y - wx
    tau_t = r_t + jnp.dot(z_y, hy64) + jnp.dot(z_x, hx64)
    ey = z_y - vy0 - y0
    rel_x0 = alpha * z_x + (1.0 - alpha) * x0
    rel_t0 = alpha * tau_t + (1.0 - alpha) * tau0
    # prox anchors: t0 rounded to the f32 the kernel holds, residue into
    # et; s0/prox(t0) computed in f64 FROM the rounded t0 (consistency)
    t0x_32 = (rel_x0 - vx0).astype(f32)
    etx = (rel_x0 - vx0) - t0x_32.astype(f64)
    t0x64 = t0x_32.astype(f64)
    sax64 = jnp.sqrt(t0x64 * t0x64 + 4.0 * lam)
    xa = jnp.where(t0x64 >= 0, 0.5 * (t0x64 + sax64),
                   2.0 * lam / (sax64 - t0x64))
    ex = xa - x0
    evx = x0 - rel_x0
    t0t_32 = (rel_t0 - kap0).astype(f32)
    ett = (rel_t0 - kap0) - t0t_32.astype(f64)
    t0t64 = t0t_32.astype(f64)
    sat = jnp.sqrt(t0t64 * t0t64 + 4.0 * lam)
    taua = jnp.where(t0t64 >= 0, 0.5 * (t0t64 + sat),
                     2.0 * lam / (sat - t0t64))
    etau = taua - tau0
    evtau = tau0 - rel_t0
    # qres anchors (`abip.c:1951-1996`; h = (-b; c))
    q1_0 = A64 @ x0 + tau0 * hy64
    q2_0 = A64.T @ y0 + vx0 - tau0 * hx64
    q3_0 = -jnp.dot(y0, hy64) - jnp.dot(x0, hx64) - kap0
    un0 = jnp.dot(y0, y0) + jnp.dot(x0, x0) + tau0 * tau0
    vn0 = jnp.dot(vy0, vy0) + jnp.dot(vx0, vx0) + kap0 * kap0
    # average history in the anchor frame
    sjf = sj.astype(f64)
    c0y = u_sum[:m] - sjf * y0
    c0x = u_sum[m:m + n] - sjf * x0
    c0vx = v_sum[m:m + n] - sjf * vx0
    c0tau = u_sum[m + n] - sjf * tau0
    c0kap = v_sum[m + n] - sjf * kap0

    scal = jnp.stack([jnp.asarray(s, f64).astype(f32) for s in (
        rho_y, 1.0 / (g_th + 1.0), lam, alpha, thresh, tau0, kap0,
        t0t64, sat, ett, etau, evtau, q3_0, un0, vn0, sjf, c0tau, c0kap,
        qres)])
    if A32 is None:
        A32 = A64.astype(f32)
    if Ninv32 is None:
        Ninv32 = solve64(jnp.eye(m, dtype=f64)).astype(f32)
    return DeltaAnchor(
        scal=scal, A=A32, Ninv=Ninv32,
        hy=hy64.astype(f32), hx=hx64.astype(f32),
        gy=g[:m].astype(f32), gx=g[m:m + n].astype(f32),
        ey=ey.astype(f32), ex=ex.astype(f32), evx=evx.astype(f32),
        t0x=t0x_32, sax=sax64.astype(f32), etx=etx.astype(f32),
        q1_0=q1_0.astype(f32), q2_0=q2_0.astype(f32),
        y0=y0.astype(f32), x0=x0.astype(f32), vx0=vx0.astype(f32),
        c0y=c0y.astype(f32), c0x=c0x.astype(f32), c0vx=c0vx.astype(f32))


class DeltaResult(NamedTuple):
    u: jnp.ndarray         # f64 absolute iterate after the chunk
    v: jnp.ndarray
    u_sum: jnp.ndarray     # f64 stage-average accumulators AFTER chunk
    v_sum: jnp.ndarray
    t_done: jnp.ndarray    # int32 iterations executed
    qres: jnp.ndarray      # f64 inner-criterion value (delta-frame)
    avg_crit: jnp.ndarray  # bool: averaged iterate is the better candidate


def run_delta_chunk(A64, solve64, h, g, g_th, rho_y, lam, alpha, thresh,
                    u, v, u_sum, v_sum, sj, qres, *, T, probe,
                    A32=None, Ninv32=None) -> DeltaResult:
    """One anchored-delta chunk: build the anchor (f64), run up to T f32
    iterations stopping at `qres < thresh`, return the f64 state.

    The iterations run in the Triton kernel where `use_kernel` says so,
    else in `_delta_ref`.  vmap-able: under vmap the kernel runs one
    program per lane with per-lane stopping.
    `u_sum`/`v_sum`/`sj` thread the stage-average accumulators (see
    `parallel/batched.py` C docstring for why they must survive chunk
    boundaries)."""
    m, n = A64.shape
    anc = delta_anchor(A64, solve64, h, g, g_th, rho_y, lam, alpha,
                       thresh, u, v, u_sum, v_sum, sj, qres,
                       A32=A32, Ninv32=Ninv32)
    if use_kernel(m, n):
        out = _delta_kernel_call(anc, T, probe)
    else:
        out = _delta_ref(anc, T, probe)
    dy, dx, dvx, dsy, dsx, dsvx, row = out
    dtau = row[0].astype(f64)
    dkap = row[1].astype(f64)
    dstau = row[2].astype(f64)
    dskap = row[3].astype(f64)
    q = row[4].astype(f64)
    t_done = row[5].astype(jnp.int32)
    avg_crit = row[6] > 0.5
    # absolute f64 state: exact anchor frame + deltas
    kf = t_done.astype(f64)
    u_new = jnp.concatenate([
        u[:m] + dy.astype(f64), u[m:m + n] + dx.astype(f64),
        (u[m + n] + dtau)[None]])
    v_new = jnp.concatenate([
        v[:m], v[m:m + n] + dvx.astype(f64), (v[m + n] + dkap)[None]])
    u_sum_new = u_sum + kf * u + jnp.concatenate([
        dsy.astype(f64), dsx.astype(f64), dstau[None]])
    v_sum_new = v_sum + kf * v + jnp.concatenate([
        jnp.zeros((m,), f64), dsvx.astype(f64), dskap[None]])
    return DeltaResult(u=u_new, v=v_new, u_sum=u_sum_new,
                       v_sum=v_sum_new, t_done=t_done, qres=q,
                       avg_crit=avg_crit)
