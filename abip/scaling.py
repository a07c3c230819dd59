"""Matrix equilibration: the four composable rescalings of the reference.

JAX re-derivation of `ABIP(_normalize_A)`
(`/root/reference/src/abip-lp/linsys/common.c:150-565`): pc (sqrt-L1
col/row), origin (L2), Ruiz (iterated sqrt-Linf), and qp (geometric
min*max).  The reference mutates a CSC matrix nonzero-by-nonzero; here each
pass is a pair of row/column reductions + a rank-1 rescale on the dense
operand -- embarrassingly parallel on the VPU, and the whole pipeline jits
into a handful of fused kernels.

D and E accumulate all applied row/column scalings so that
A_scaled = diag(1/D) @ A @ diag(1/E) * scale.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

MIN_SCALE = 1e-3
MAX_SCALE = 1e3


class ScalingData(NamedTuple):
    D: jnp.ndarray           # row scalings (m,)
    E: jnp.ndarray           # column scalings (n,)
    mean_norm_row: jnp.ndarray  # mean row 2-norm of the scaled A
    mean_norm_col: jnp.ndarray  # mean col 2-norm of the scaled A



# f32 scaling-factor loops pay only at size (the full-matrix passes are
# the cost) and ppm-level factor noise can flip marginal SMALL conic
# instances across a stability edge (measured: an 8x20 SOC instance
# NaN'd at 7k iterations with f32 factors, solved in 497 with f64 --
# the factors differed by 1.6e-7 relative).  Below this element count
# the loops stay f64 (trajectories bit-match the pre-optimization
# behavior); above it the f32 loop saves ~1-2 s per call at dim-1020.
_F32_SCALING_MIN_ELEMS = 1 << 18


def _factor_dtype(A):
    return jnp.float32 if A.size >= _F32_SCALING_MIN_ELEMS else A.dtype

def _clip_col(e, n_rows):
    """Column-scale guard (`common.c:224-229`): tiny -> 1, huge -> cap."""
    lo = MIN_SCALE * jnp.sqrt(jnp.asarray(n_rows, e.dtype))
    hi = MAX_SCALE * jnp.sqrt(jnp.asarray(n_rows, e.dtype))
    return jnp.where(e < lo, 1.0, jnp.minimum(e, hi))


def _pc_pass(A):
    """sqrt-L1 column then row scaling (`common.c:217-266`)."""
    m, n = A.shape
    e = jnp.sqrt(jnp.sum(jnp.abs(A), axis=0))
    E = _clip_col(e, m)
    A = A / E[None, :]
    d = jnp.sqrt(jnp.sum(jnp.abs(A), axis=1))
    D = _clip_col(d, n)
    A = A / D[:, None]
    return A, D, E


def _origin_pass(A):
    """L2 column then row scaling (`common.c:279-327`)."""
    m, n = A.shape
    e = jnp.linalg.norm(A, axis=0)
    E = _clip_col(e, m)
    A = A / E[None, :]
    d = jnp.linalg.norm(A, axis=1)
    D = _clip_col(d, n)
    A = A / D[:, None]
    return A, D, E


def _ruiz_pass(A, iters):
    """Iterated sqrt-Linf scaling (`common.c:339-413`)."""
    m, n = A.shape

    def body(_, carry):
        A, D, E = carry
        e = jnp.sqrt(jnp.max(jnp.abs(A), axis=0))
        Et = _clip_col(e, m)
        A = A / Et[None, :]
        d = jnp.sqrt(jnp.max(jnp.abs(A), axis=1))
        Dt = _clip_col(d, n)
        A = A / Dt[:, None]
        return A, D * Dt, E * Et

    D0 = jnp.ones((m,), A.dtype)
    E0 = jnp.ones((n,), A.dtype)
    return jax.lax.fori_loop(0, iters, body, (A, D0, E0))


def _qp_pass(A):
    """Geometric-mean (min*max of |nonzeros|) scaling (`common.c:415-509`)."""
    m, n = A.shape
    absA = jnp.abs(A)
    big = jnp.where(absA > 0, absA, -jnp.inf)
    small = jnp.where(absA > 0, absA, jnp.inf)

    col_max = jnp.max(big, axis=0)
    col_min = jnp.min(small, axis=0)
    e = jnp.sqrt(jnp.where(jnp.isfinite(col_max), col_min * col_max, 0.0))
    E = _clip_col(e, m)
    A = A / E[None, :]

    absA = jnp.abs(A)
    big = jnp.where(absA > 0, absA, -jnp.inf)
    small = jnp.where(absA > 0, absA, jnp.inf)
    row_max = jnp.max(big, axis=1)
    row_min = jnp.min(small, axis=1)
    d = jnp.sqrt(jnp.where(jnp.isfinite(row_max), row_min * row_max, 0.0))
    D = _clip_col(d, n)
    A = A / D[:, None]
    return A, D, E


class ConicScalingData(NamedTuple):
    D: jnp.ndarray
    E: jnp.ndarray
    sc_b: jnp.ndarray
    sc_c: jnp.ndarray


def _clip_keep(v, n_other):
    """Conic variant of the scale guard (`qcp_config.c:220-232`)."""
    lo = MIN_SCALE * jnp.sqrt(jnp.asarray(n_other, v.dtype))
    hi = MAX_SCALE * jnp.sqrt(jnp.asarray(n_other, v.dtype))
    return jnp.where(v < lo, 1.0, jnp.minimum(v, hi))


def equilibrate_conic(A, Q, b, c, layout, settings):
    """Conic equilibration (`scaling_qcp_data`, `qcp_config.c:91-491`).

    Column scalings are computed from BOTH A and Q (elementwise max), tied
    to a common value within each SOC/RSOC block (so cone geometry is
    preserved), then applied as A <- A E^-1 D^-1-rows, Q <- E^-1 Q E^-1.
    Order matches the reference: ruiz (10 iters) -> origin -> pc, followed
    by b/c scaling with sc = (||b||^2+||c||^2)^(1/4) of the ORIGINAL data.

    Q may be a full (n, n) matrix or a 1-D (n,) DIAGONAL: the reference
    scales by the Q columns either way (a diagonal's column reductions
    are |q_j|), so diagonal-Q problems must not skip the Q term in E --
    doing so was a measured trajectory-parity gap vs the C solver.
    """
    m, n = A.shape
    dtype = A.dtype
    q_diag = Q is not None and Q.ndim == 1
    D_hat = jnp.ones((m,), dtype)
    E_hat = jnp.ones((n,), dtype)

    # sc from the un-equilibrated b, c (`qcp_config.c:462-463`)
    sc = jnp.sqrt(jnp.sqrt(jnp.sum(c * c) + jnp.sum(b * b)))
    sc = jnp.where(sc < MIN_SCALE, 1.0, jnp.minimum(sc, MAX_SCALE))
    sc_b = 1.0 / sc
    sc_c = 1.0 / sc

    def col_metric(A, Q, kind):
        if kind == "inf":
            e1 = jnp.sqrt(jnp.max(jnp.abs(A), axis=0))
        elif kind == "l2":
            e1 = jnp.sqrt(jnp.linalg.norm(A, axis=0))
        else:  # l1
            e1 = jnp.sqrt(jnp.sum(jnp.abs(A), axis=0))
        if Q is None:
            return e1
        if q_diag:
            # any column reduction of a diagonal matrix is |q_j|
            e2 = jnp.sqrt(jnp.abs(Q))
        elif kind == "inf":
            e2 = jnp.sqrt(jnp.max(jnp.abs(Q), axis=0))
        elif kind == "l2":
            e2 = jnp.sqrt(jnp.linalg.norm(Q, axis=0))
        else:
            e2 = jnp.sqrt(jnp.sum(jnp.abs(Q), axis=0))
        return jnp.maximum(e1, e2)

    def row_metric(A, kind):
        if kind == "inf":
            return jnp.sqrt(jnp.max(jnp.abs(A), axis=1))
        if kind == "l2":
            return jnp.sqrt(jnp.sqrt(jnp.sum(A * A, axis=1)))
        return jnp.sqrt(jnp.sum(jnp.abs(A), axis=1))

    def one_pass(A, Q, D_hat, E_hat, kind):
        E = col_metric(A, Q, kind)
        E = layout.segment_mean_tie(E)
        E = _clip_keep(E, m)
        D = row_metric(A, kind)
        D = _clip_keep(D, n)
        A = A / E[None, :] / D[:, None]
        if Q is not None:
            Q = Q / (E * E) if q_diag else Q / E[None, :] / E[:, None]
        return A, Q, D_hat * D, E_hat * E

    # The scaling-factor loop runs in f32: each pass rewrites the full
    # matrix (11 full (m, n) elementwise passes at ruiz_iter=10), half
    # the bytes in f32.  Scalings
    # are equilibration HEURISTICS -- 3 significant digits is plenty --
    # so the factors are accumulated in f32 and applied ONCE to the f64
    # data at the end (one f64 pass instead of 11).
    fdt = _factor_dtype(A)
    A_it, Q_it = A.astype(fdt), (None if Q is None else Q.astype(fdt))
    D32 = D_hat.astype(fdt)
    E32 = E_hat.astype(fdt)
    if settings.pc_ruiz_rescale:  # ruiz_scaling in the conic reference
        for _ in range(settings.ruiz_iter):
            A_it, Q_it, D32, E32 = one_pass(A_it, Q_it, D32, E32, "inf")
    if settings.origin_rescale:
        A_it, Q_it, D32, E32 = one_pass(A_it, Q_it, D32, E32, "l2")
    if settings.qp_rescale:  # pc_scaling slot in the conic reference
        A_it, Q_it, D32, E32 = one_pass(A_it, Q_it, D32, E32, "l1")
    D_hat = D32.astype(dtype)
    E_hat = E32.astype(dtype)
    A = A / E_hat[None, :] / D_hat[:, None]
    if Q is not None:
        Q = Q / (E_hat * E_hat) if q_diag else \
            Q / E_hat[None, :] / E_hat[:, None]

    b = b / D_hat * (sc_b * settings.scale)
    c = c / E_hat * (sc_c * settings.scale)
    return A, Q, b, c, ConicScalingData(D=D_hat, E=E_hat, sc_b=sc_b, sc_c=sc_c)


def equilibrate_sparse(A, settings):
    """Host-side equilibration of a scipy sparse matrix: the same pc ->
    ruiz pipeline as `equilibrate`, run once at setup in scipy (sparse
    row/col reductions), returning the scaled CSR matrix and ScalingData.
    """
    import numpy as np
    import scipy.sparse as sp

    A = sp.csr_matrix(A, dtype=np.float64, copy=True)
    m, n = A.shape
    D = np.ones(m)
    E = np.ones(n)

    def clip_col(e, n_other):
        lo = MIN_SCALE * np.sqrt(n_other)
        hi = MAX_SCALE * np.sqrt(n_other)
        return np.where(e < lo, 1.0, np.minimum(e, hi))

    def scale(A, d, e):
        return sp.diags(1.0 / d) @ A @ sp.diags(1.0 / e)

    absA = abs(A)
    if settings.pc_ruiz_rescale:
        e = clip_col(np.sqrt(np.asarray(absA.sum(axis=0)).ravel()), m)
        A = A @ sp.diags(1.0 / e)
        d = clip_col(np.sqrt(np.asarray(abs(A).sum(axis=1)).ravel()), n)
        A = sp.diags(1.0 / d) @ A
        D *= d
        E *= e
        for _ in range(settings.ruiz_iter):
            absA = abs(A)
            e = clip_col(np.sqrt(absA.max(axis=0).toarray().ravel()), m)
            A = A @ sp.diags(1.0 / e)
            d = clip_col(np.sqrt(abs(A).max(axis=1).toarray().ravel()), n)
            A = sp.diags(1.0 / d) @ A
            D *= d
            E *= e

    sq = A.copy()
    sq.data = sq.data**2
    row_norms = np.sqrt(np.asarray(sq.sum(axis=1)).ravel())
    col_norms = np.sqrt(np.asarray(sq.sum(axis=0)).ravel())
    if settings.scale != 1:
        A = A * settings.scale
    return A, ScalingData(
        D=jnp.asarray(D), E=jnp.asarray(E),
        mean_norm_row=jnp.asarray(row_norms.mean()),
        mean_norm_col=jnp.asarray(col_norms.mean()),
    )


def normalize_bc(scal: ScalingData, b, c, scale):
    """b/c normalization after equilibration (`normalize.c:11-40`).

    Jit-safe; the single source for the sequence shared by the LP
    workspace (dense and sparse setup) and the device driver:
    scale each vector by the equilibration diagonals, then by
    mean-norm / max(||.||, 1e-3), then by the global `scale`.
    Returns (b_s, c_s, sc_b, sc_c)."""
    c_s = c / scal.E
    sc_c = scal.mean_norm_row / jnp.maximum(jnp.linalg.norm(c_s), 1e-3)
    b_s = b / scal.D
    sc_b = scal.mean_norm_col / jnp.maximum(jnp.linalg.norm(b_s), 1e-3)
    return b_s * sc_b * scale, c_s * sc_c * scale, sc_b, sc_c


def equilibrate(A: jnp.ndarray, settings) -> tuple[jnp.ndarray, ScalingData]:
    """Full pipeline (`common.c:150-565`): pc -> origin -> ruiz -> qp.

    Returns the scaled matrix (including the global `scale` factor) and the
    accumulated D/E plus the mean row/col norms used by b/c normalization.
    """
    m, n = A.shape
    # scaling-factor passes in f32 (heuristics: 3 digits is plenty), ONE
    # f64 application at the end -- each pass rewrites the full matrix
    # (same optimization as equilibrate_conic; D/E/trajectory differences are
    # in the scalings' low bits only)
    fdt = _factor_dtype(A)
    A_it = A.astype(fdt)
    D = jnp.ones((m,), fdt)
    E = jnp.ones((n,), fdt)

    if settings.pc_ruiz_rescale:
        A_it, Dp, Ep = _pc_pass(A_it)
        D, E = D * Dp, E * Ep
    if settings.origin_rescale:
        A_it, Do, Eo = _origin_pass(A_it)
        D, E = D * Do, E * Eo
    if settings.pc_ruiz_rescale:
        A_it, Dr, Er = _ruiz_pass(A_it, settings.ruiz_iter)
        D, E = D * Dr, E * Er
    if settings.qp_rescale:
        A_it, Dq, Eq = _qp_pass(A_it)
        D, E = D * Dq, E * Eq

    D = D.astype(A.dtype)
    E = E.astype(A.dtype)
    A = A / E[None, :] / D[:, None]

    mean_norm_row = jnp.mean(jnp.linalg.norm(A, axis=1))
    mean_norm_col = jnp.mean(jnp.linalg.norm(A, axis=0))

    if settings.scale != 1:
        A = A * settings.scale

    return A, ScalingData(D=D, E=E, mean_norm_row=mean_norm_row,
                          mean_norm_col=mean_norm_col)
