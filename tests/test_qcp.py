"""Conic/QP driver tests: analytic solutions + KKT verification.

Golden strategy (SURVEY.md section 4): closed-form conic toys (SOC/RSOC
projections with known optima), LP-as-conic cross-checked against scipy,
and solver-independent KKT verification for general QPs.
"""
import numpy as np
import pytest
from scipy.optimize import linprog

import abip
from abip import ConeSpec
from tests.conftest import random_lp


def kkt_check(A, b, c, Q, sol, tol):
    """Solver-independent optimality check:
    Ax=b, Qx + c - A'y - s = 0, gap small."""
    x, y, s = sol.x, sol.y, sol.s
    Qx = Q @ x if Q is not None else 0.0
    assert np.linalg.norm(A @ x - b, np.inf) < tol * (1 + np.abs(b).max())
    dres = Qx + c - A.T @ y - s
    assert np.linalg.norm(dres, np.inf) < tol * (1 + np.abs(c).max())
    pobj = 0.5 * x @ Qx + c @ x if Q is not None else c @ x
    dobj = -0.5 * x @ Qx + b @ y if Q is not None else b @ y
    assert abs(pobj - dobj) < tol * (1 + abs(pobj) + abs(dobj))


def test_lp_as_conic(rng):
    A, b, c = random_lp(rng, 15, 40)
    ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, None), method="highs").fun
    sol = abip.solve_qcp(A, b, c, ConeSpec.lp(40), eps=1e-5)
    assert sol.status_name in ("Solved", "Solved/Inaccurate")
    assert sol.pobj == pytest.approx(ref, abs=1e-3 * (1 + abs(ref)))
    kkt_check(A, b, c, None, sol, 1e-3)


def test_soc_norm_minimization(rng):
    # min t s.t. x = a, (t, x) in SOC  ->  t* = ||a||
    a = rng.standard_normal(4)
    n = 5
    A = np.zeros((4, n))
    A[:, 1:] = np.eye(4)
    b = a
    c = np.zeros(n)
    c[0] = 1.0
    sol = abip.solve_qcp(A, b, c, ConeSpec(soc=(5,)), eps=1e-5)
    assert sol.status_name in ("Solved", "Solved/Inaccurate")
    assert sol.pobj == pytest.approx(np.linalg.norm(a), abs=1e-3)


def test_rsoc_squared_norm(rng):
    # min t1 s.t. t2 = 1, x = a, (t1,t2,x) in RSOC -> t1* = ||a||^2/2
    a = rng.standard_normal(3)
    n = 5
    A = np.zeros((4, n))
    A[0, 1] = 1.0
    A[1:, 2:] = np.eye(3)
    b = np.concatenate([[1.0], a])
    c = np.zeros(n)
    c[0] = 1.0
    sol = abip.solve_qcp(A, b, c, ConeSpec(rsoc=(5,)), eps=1e-5)
    assert sol.status_name in ("Solved", "Solved/Inaccurate")
    assert sol.pobj == pytest.approx(0.5 * np.sum(a * a), abs=1e-3)


def test_qp_box_analytic():
    # min 1/2||x - z||^2 s.t. sum(x) = 1, x >= 0: projection of z onto simplex
    n = 6
    rng = np.random.default_rng(3)
    z = rng.standard_normal(n)
    Q = np.eye(n)
    c = -z
    A = np.ones((1, n))
    b = np.array([1.0])
    sol = abip.solve_qcp(A, b, c, ConeSpec.lp(n), Q=Q, eps=1e-6)
    assert sol.status_name in ("Solved", "Solved/Inaccurate")

    # analytic simplex projection
    u = np.sort(z)[::-1]
    css = np.cumsum(u)
    rho = np.nonzero(u * np.arange(1, n + 1) > (css - 1))[0][-1]
    theta = (css[rho] - 1) / (rho + 1.0)
    x_star = np.maximum(z - theta, 0)
    np.testing.assert_allclose(sol.x, x_star, atol=5e-4)
    kkt_check(A, b, c, Q, sol, 1e-3)


def test_random_eq_qp_kkt(rng):
    # min 1/2 x'Qx + c'x s.t. Ax=b, x free: analytic KKT solution available
    m, n = 8, 20
    G = rng.standard_normal((n, n))
    Q = G @ G.T + np.eye(n)
    A = rng.standard_normal((m, n))
    x_free = rng.standard_normal(n)
    b = A @ x_free
    c = rng.standard_normal(n)
    sol = abip.solve_qcp(A, b, c, ConeSpec(free=n), Q=Q, eps=1e-6)
    assert sol.status_name in ("Solved", "Solved/Inaccurate")
    # analytic: solve [[Q, A'],[A, 0]] [x; -y] = [-c; b]
    KKT = np.block([[Q, A.T], [A, np.zeros((m, m))]])
    rhs = np.concatenate([-c, b])
    xy = np.linalg.solve(KKT, rhs)
    x_star = xy[:n]
    pobj_star = 0.5 * x_star @ Q @ x_star + c @ x_star
    assert sol.pobj == pytest.approx(pobj_star, abs=1e-3 * (1 + abs(pobj_star)))


def test_mixed_cones(rng):
    # portfolio-like: min -mu'w + risk bound via SOC, sum w = 1, w >= 0
    n_assets = 6
    F = rng.standard_normal((n_assets, n_assets)) / np.sqrt(n_assets)
    mu_ret = rng.random(n_assets)
    gamma_risk = 2.0
    # vars: [w (n), t (1), u (n)]  where u = F w, (t, u) in SOC
    # min -mu'w + gamma*t  s.t. sum w = 1; F w - u = 0; w >= 0
    n = n_assets + 1 + n_assets
    m = 1 + n_assets
    A = np.zeros((m, n))
    A[0, :n_assets] = 1.0
    A[1:, :n_assets] = F
    A[1:, n_assets + 1 :] = -np.eye(n_assets)
    b = np.zeros(m)
    b[0] = 1.0
    c = np.zeros(n)
    c[:n_assets] = -mu_ret
    c[n_assets] = gamma_risk
    # cone ordering: soc block first, then nonneg -> reorder variables:
    # [t, u (n), w (n)] with soc=(1+n), nonneg=n
    perm = np.concatenate([[n_assets], np.arange(n_assets + 1, n),
                           np.arange(n_assets)])
    Ap = A[:, perm]
    cp = c[perm]
    cones = ConeSpec(soc=(1 + n_assets,), nonneg=n_assets)
    sol = abip.solve_qcp(Ap, b, cp, cones, eps=1e-5)
    assert sol.status_name in ("Solved", "Solved/Inaccurate")
    w = sol.x[1 + n_assets :]
    assert w.sum() == pytest.approx(1.0, abs=1e-3)
    assert w.min() > -1e-4
    t = sol.x[0]
    assert t == pytest.approx(np.linalg.norm(F @ w), abs=1e-3)


def test_unified_dispatch(rng):
    A, b, c = random_lp(rng, 10, 30)
    s_lp = abip.solve(A, b, c, eps=1e-5)
    assert type(s_lp).__name__ == "LPSolution"
    s_conic = abip.solve(A, b, c, Q=np.eye(30), eps=1e-5)
    assert type(s_conic).__name__ == "ConicSolution"
    assert s_lp.status_name.startswith("Solved")
    assert s_conic.status_name.startswith("Solved")


def test_inverse_mixed_dense_mode_matches_chol(rng):
    """dense_mode='inverse_mixed' (f32 explicit inverse + f64 IR) must
    track the Cholesky trajectory on LP-cone and SOC instances."""
    from abip.qcp import ConicWorkspace, conic_defaults

    A, b, c = random_lp(rng, 15, 40)
    s0 = conic_defaults(eps=1e-6)
    s1 = conic_defaults(eps=1e-6, dense_mode="inverse_mixed")
    r0 = ConicWorkspace(A, b, c, ConeSpec.lp(40), settings=s0).solve()
    r1 = ConicWorkspace(A, b, c, ConeSpec.lp(40), settings=s1).solve()
    assert r1.status_name.startswith("Solved")
    assert r1.pobj == pytest.approx(r0.pobj, abs=1e-5 * (1 + abs(r0.pobj)))
    assert abs(r1.admm_iters - r0.admm_iters) <= max(5, 0.05 * r0.admm_iters)

    a = rng.standard_normal(4)
    n = 5
    A2 = np.zeros((4, n)); A2[:, 1:] = np.eye(4)
    c2 = np.zeros(n); c2[0] = 1.0
    r2 = ConicWorkspace(A2, a, c2, ConeSpec(soc=(5,)), settings=s1).solve()
    assert r2.pobj == pytest.approx(np.linalg.norm(a), abs=1e-4)


def test_conic_shape_shared_compile(rng):
    """Same-shape conic instances must share ONE compiled inner loop:
    instance data rides as pytree arguments into the module-level jitted
    driver, not as closure constants (per-instance recompiles measured
    ~0.8s each before the refactor)."""
    from abip.qcp import _run_inner_shared

    cones = ConeSpec(soc=(6,), nonneg=17)
    sols = []
    before = None
    for seed in (101, 202):
        r = np.random.default_rng(seed)
        A = r.standard_normal((9, cones.dim))
        x0 = np.abs(r.standard_normal(cones.dim)) + 0.5
        b = A @ x0
        c = A.T @ r.standard_normal(9) + np.abs(r.standard_normal(cones.dim))
        sols.append(abip.solve_qcp(A, b, c, cones, eps=1e-4))
        if before is None:
            before = _run_inner_shared._cache_size()
    assert _run_inner_shared._cache_size() == before  # second solve: no new compile
    assert all(s.status == 1 for s in sols)
