"""Fused conic DR sprint vs the shared conic_ops step math.

The sprint (`ops/conic_sprint.py`) re-implements the projection /
cone-prox / dual-update iteration with matmul-encoded segment ops; these
tests pin it to the f64 `conic_ops` + `cones` implementations the host
and device drivers use (reference parity of those is established by
tests/test_qcp.py and the parity harness)."""
from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from abip.cones import ConeLayout, ConeSpec, cone_barrier_prox
from abip import conic_ops
from abip.linsys.schur import DenseSchurSolver
from abip.ops.conic_sprint import (_cone_prox, cone_kernel_data,
                                   fused_dr_sprint_stop)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


SPEC = ConeSpec(soc=(5, 7), rsoc=(4, 6), nonneg=20, free=3, zero=2)


def test_cone_prox_matches_segment_impl(rng):
    lay = ConeLayout(SPEC)
    n = lay.n
    cd = cone_kernel_data(lay)
    lam = 0.037
    for seed in range(5):
        r = np.random.default_rng(seed)
        t = r.standard_normal(n) * (1.0 + 2.0 * r.random(n))
        want = np.asarray(cone_barrier_prox(
            jnp.asarray(t), jnp.full((n,), lam), lay))
        tx = jnp.asarray(t, jnp.float32)[None, :]
        got = np.asarray(_cone_prox(tx, jnp.float32(lam), cd))[0]
        kind = np.asarray(lay.kind)
        want = np.where(kind == 2, 0.0, want)  # _ZERO
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def _setup_problem(rng, spec=SPEC, m=None, with_q=False):
    lay = ConeLayout(spec)
    n = lay.n
    m = m or n // 3
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    x0 = np.asarray(lay.interior_point(jnp.float64))
    b = A @ x0
    c = rng.standard_normal(n)
    Qd = (rng.random(n) + 0.1) if with_q else None
    return lay, jnp.asarray(A), jnp.asarray(b), jnp.asarray(c), \
        (jnp.asarray(Qd) if Qd is not None else None)


def _steps_reference(A, b, c, Qd, lay, rho_y, rho_x, rho_tau, lam, alpha,
                     T, u0, v0, k0=0):
    """T iterations through the f64 conic_ops path."""
    m, n = A.shape
    rho = jnp.concatenate([jnp.full((m,), rho_y), jnp.full((n,), rho_x),
                           jnp.full((1,), rho_tau)])
    dss = DenseSchurSolver(A, Qd, rho[:m], rho[m:m + n], mode="chol",
                           form="primal")

    def Q_times(x):
        return jnp.zeros_like(x) if Qd is None else Qd * x

    def solve_fn(w_y, w_x, k, warm):
        return dss.solve(w_y, w_x)

    r_y, r_x, _ = solve_fn(-b, c, -1, None)
    r_vec = jnp.concatenate([r_y, r_x])
    a_coef = rho_tau + jnp.dot(rho[:m + n] * r_vec, r_vec)
    u, v = u0, v0
    for k in range(k0, k0 + T):
        u_t, _ = conic_ops.projection(u, v, solve_fn, rho, r_vec, a_coef,
                                      Q_times, m, n, jnp.asarray(k))
        u, v = conic_ops.barrier_and_dual(u, v, u_t, jnp.asarray(lam),
                                          rho[m:], lay, alpha, m, n)
    return u, v, r_vec, a_coef, dss


def _steps_f32(A, b, c, Qd, lay, Sinv32, rho_y, rho_x, rho_tau, lam,
               alpha, T, u0, v0, k0=0):
    """T iterations through conic_ops in f32 with the SAME explicit
    f32-inverse solve the kernel uses -- isolates math equivalence from
    f32-vs-f64 drift."""
    m, n = A.shape
    f = jnp.float32
    A32 = A.astype(f)
    rho = jnp.concatenate([jnp.full((m,), rho_y, f), jnp.full((n,), rho_x, f),
                           jnp.full((1,), rho_tau, f)])

    def Q_times(x):
        return jnp.zeros_like(x) if Qd is None else Qd.astype(f) * x

    def solve_fn(w_y, w_x, k, warm):
        with jax.default_matmul_precision("highest"):
            rhs = w_x + (1.0 / rho_y) * (A32.T @ w_y)
            z_x = Sinv32 @ rhs
            z_y = (1.0 / rho_y) * (w_y - A32 @ z_x)
        return z_y, z_x, jnp.zeros((), jnp.int32)

    with jax.default_matmul_precision("highest"):
        r_y, r_x, _ = solve_fn(-b.astype(f), c.astype(f), -1, None)
        r_vec = jnp.concatenate([r_y, r_x])
        a_coef = rho_tau + jnp.dot(rho[:m + n] * r_vec, r_vec)
        u, v = u0.astype(f), v0.astype(f)
        for k in range(k0, k0 + T):
            u_t, _ = conic_ops.projection(u, v, solve_fn, rho, r_vec,
                                          a_coef, Q_times, m, n,
                                          jnp.asarray(k))
            u, v = conic_ops.barrier_and_dual(u, v, u_t, jnp.asarray(lam, f),
                                              rho[m:], lay, alpha, m, n)
    return u, v, r_vec, a_coef


@pytest.mark.parametrize("with_q", [False, True])
def test_dr_sprint_matches_steps(rng, with_q):
    lay, A, b, c, Qd = _setup_problem(rng, with_q=with_q)
    m, n = A.shape
    # rho_y = 1 for the identical-math check: z_y = (w_y - A z_x)/rho_y
    # amplifies f32 rounding-order differences by 1/rho_y, so at the
    # production 1e-3 two CORRECT f32 implementations only agree to
    # ~1e-4 in the y block (solve-level accuracy at production rho is
    # covered by the sprint-engine device-solve tests)
    rho_y, rho_x, rho_tau = 1.0, 1.0, 1.0
    lam, alpha = 0.05, 1.8
    T = 8
    u0 = jnp.concatenate([jnp.zeros((m,)), lay.interior_point(jnp.float64),
                          jnp.ones((1,))])
    v0 = u0
    u_ref64, v_ref64, _, _, _ = _steps_reference(
        A, b, c, Qd, lay, rho_y, rho_x, rho_tau, lam, alpha, T, u0, v0)

    Sinv = jnp.linalg.inv(
        rho_x * jnp.eye(n) + (A * (1.0 / rho_y)).T @ A
        + (jnp.diag(Qd) if Qd is not None else 0.0))
    Sinv32 = Sinv.astype(jnp.float32)
    u_ref, v_ref, r_vec, a_coef = _steps_f32(
        A, b, c, Qd, lay, Sinv32, rho_y, rho_x, rho_tau, lam, alpha, T,
        u0, v0)
    cd = cone_kernel_data(lay)
    Qd32 = (Qd if Qd is not None else jnp.zeros((n,)))
    u_k, v_k, t_done, err = fused_dr_sprint_stop(
        A.astype(jnp.float32), Sinv32,
        jnp.zeros((n,), jnp.float32), r_vec.astype(jnp.float32),
        b.astype(jnp.float32), c.astype(jnp.float32),
        Qd32.astype(jnp.float32), cd, rho_y, rho_x, rho_tau,
        a_coef, lam, alpha, 0.0,  # thresh 0: never stop early
        u0.astype(jnp.float32), v0.astype(jnp.float32),
        jnp.float32(0.0), T=T, probe=4)
    assert int(t_done) == T
    # identical-math check vs the f32 conic_ops trajectory
    np.testing.assert_allclose(np.asarray(u_k), np.asarray(u_ref),
                               rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(np.asarray(v_k), np.asarray(v_ref),
                               rtol=3e-5, atol=3e-5)
    # f32-drift sanity vs the f64 trajectory (loose: cond(S) ~ 1/rho_y)
    np.testing.assert_allclose(np.asarray(u_k), np.asarray(u_ref64),
                               rtol=2e-2, atol=2e-2)


def test_dr_sprint_woodbury_matches_primal(rng):
    # diagonal-H dual form: m < n, no full Q; rho_y = 1 (see the
    # rounding-amplification note in test_dr_sprint_matches_steps)
    lay, A, b, c, _ = _setup_problem(rng)
    m, n = A.shape
    rho_y, rho_x, rho_tau = 1.0, 1.0, 1.0
    lam, alpha = 0.05, 1.8
    T = 8
    u0 = jnp.concatenate([jnp.zeros((m,)), lay.interior_point(jnp.float64),
                          jnp.ones((1,))])
    v0 = u0
    _, _, r_vec, a_coef, _ = _steps_reference(
        A, b, c, None, lay, rho_y, rho_x, rho_tau, lam, alpha, 1, u0, v0)
    Sinv = jnp.linalg.inv(rho_x * jnp.eye(n) + (A * (1.0 / rho_y)).T @ A)
    H_inv = jnp.full((n,), 1.0 / rho_x)
    G = rho_y * jnp.eye(m) + (A * H_inv[None, :]) @ A.T
    Ginv = jnp.linalg.inv(G)
    cd = cone_kernel_data(lay)
    z32 = jnp.zeros((n,), jnp.float32)
    common = dict(cd=cd, rho_y=rho_y, rho_x=rho_x, rho_tau=rho_tau,
                  a_coef=a_coef, lam=lam, alpha=alpha, thresh=0.0,
                  u32=u0.astype(jnp.float32), v32=v0.astype(jnp.float32),
                  k0=jnp.float32(0.0), T=T, probe=4)
    up, vp, _, _ = fused_dr_sprint_stop(
        A.astype(jnp.float32), Sinv.astype(jnp.float32), z32,
        r_vec.astype(jnp.float32), b.astype(jnp.float32),
        c.astype(jnp.float32), z32, woodbury=False, **common)
    uw, vw, _, _ = fused_dr_sprint_stop(
        A.astype(jnp.float32), Ginv.astype(jnp.float32),
        H_inv.astype(jnp.float32), r_vec.astype(jnp.float32),
        b.astype(jnp.float32), c.astype(jnp.float32), z32,
        woodbury=True, **common)
    np.testing.assert_allclose(np.asarray(uw), np.asarray(up),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(vw), np.asarray(vp),
                               rtol=2e-4, atol=2e-4)


def test_dr_sprint_stop_fires(rng):
    """With a loose threshold the in-kernel stop exits early and reports
    a probe-quantized t_done."""
    lay, A, b, c, _ = _setup_problem(rng)
    m, n = A.shape
    u0 = jnp.concatenate([jnp.zeros((m,)), lay.interior_point(jnp.float64),
                          jnp.ones((1,))])
    _, _, r_vec, a_coef, _ = _steps_reference(
        A, b, c, None, lay, 1e-3, 1.0, 1.0, 0.05, 1.8, 1, u0, u0)
    Sinv = jnp.linalg.inv(1.0 * jnp.eye(n) + (A * 1e3).T @ A)
    cd = cone_kernel_data(lay)
    z32 = jnp.zeros((n,), jnp.float32)
    u_k, v_k, t_done, err = fused_dr_sprint_stop(
        A.astype(jnp.float32), Sinv.astype(jnp.float32), z32,
        r_vec.astype(jnp.float32), b.astype(jnp.float32),
        c.astype(jnp.float32), z32, cd, 1e-3, 1.0, 1.0, a_coef,
        0.05, 1.8, 1e9,  # absurd threshold: stop at first probe
        u0.astype(jnp.float32), u0.astype(jnp.float32),
        jnp.float32(0.0), T=64, probe=4)
    assert int(t_done) == 4
    assert np.isfinite(float(err))


def test_dr_sprint_vmap_consistency(rng):
    """vmap over instances (XLA fallback path) matches per-instance.

    rho_y = 1: batched matmuls accumulate in a different order than the
    single-instance program, and z_y amplifies that rounding gap by
    1/rho_y (see test_dr_sprint_matches_steps)."""
    lay, A, b, c, _ = _setup_problem(rng)
    m, n = A.shape
    u0 = jnp.concatenate([jnp.zeros((m,)), lay.interior_point(jnp.float64),
                          jnp.ones((1,))])
    _, _, r_vec, a_coef, _ = _steps_reference(
        A, b, c, None, lay, 1.0, 1.0, 1.0, 0.05, 1.8, 1, u0, u0)
    Sinv = jnp.linalg.inv(1.0 * jnp.eye(n) + A.T @ A)
    cd = cone_kernel_data(lay)
    z32 = jnp.zeros((n,), jnp.float32)
    B = 3
    r2 = np.random.default_rng(9)
    us = jnp.asarray(np.stack([
        np.concatenate([np.zeros(m), np.asarray(lay.interior_point(
            jnp.float64)) * (1 + 0.1 * r2.random(n)), [1.0]])
        for _ in range(B)]), jnp.float32)

    def one(u):
        return fused_dr_sprint_stop(
            A.astype(jnp.float32), Sinv.astype(jnp.float32), z32,
            r_vec.astype(jnp.float32), b.astype(jnp.float32),
            c.astype(jnp.float32), z32, cd, 1.0, 1.0, 1.0, a_coef,
            0.05, 1.8, 0.0, u, u, jnp.float32(0.0), T=8, probe=4)

    uv = jax.vmap(one)(us)
    for i in range(B):
        ui, vi, ti, ei = one(us[i])
        np.testing.assert_allclose(np.asarray(uv[0][i]), np.asarray(ui),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(np.asarray(uv[1][i]), np.asarray(vi),
                                   rtol=2e-5, atol=2e-5)


def test_conic_sprint2_solves_batch():
    """engine='sprint2' (fused-kernel phase 1 + anchored steps endgame)
    reaches the randcone analytic optima at 1e-6 with iteration counts
    near the steps engine's (probe-quantized stage exits cost ~25%)."""
    from benchmarks.conic_mini import randcone
    from abip.parallel.batched_qcp import solve_qcp_batch

    cones = ConeSpec(soc=(25, 25), rsoc=(4,), nonneg=150)
    m = cones.dim // 3
    insts = [randcone(f"i{i}", m, cones, 7000 + i) for i in range(3)]
    As = jnp.asarray(np.stack([x[1] for x in insts]))
    bs = jnp.asarray(np.stack([x[2] for x in insts]))
    cs = jnp.asarray(np.stack([x[3] for x in insts]))
    kw = dict(cones=cones, eps=1e-6, precision="mixed", normalize=True,
              rho_y=1e-3, max_admm=100_000, solver="inverse",
              probe_period=8)
    r_steps = solve_qcp_batch(As, bs, cs, engine="steps",
                              inner_crit_period=8, **kw)
    r_spr = solve_qcp_batch(As, bs, cs, engine="sprint2",
                            inner_crit_period=512, **kw)
    for i in range(3):
        assert int(r_spr.status[i]) == 1
        star = insts[i][5]
        assert float(r_spr.pobj[i]) == pytest.approx(
            star, abs=1e-4 * (1 + abs(star)))
        assert int(r_spr.admm_iters[i]) <= 2 * int(r_steps.admm_iters[i]) + 64
