"""Golden tests of the LP driver against scipy.optimize.linprog.

Test strategy per SURVEY.md section 4: the reference has no unit tests, so we
build the pyramid ourselves -- random solvable LPs cross-checked against a
trusted simplex/IPM implementation, plus status classification checks.
"""
import numpy as np
import pytest
from scipy.optimize import linprog

import abip
from tests.conftest import random_lp


def scipy_opt(A, b, c):
    res = linprog(c, A_eq=A, b_eq=b, bounds=(0, None), method="highs")
    assert res.status == 0, res.message
    return res.fun


@pytest.mark.parametrize("m,n", [(10, 30), (20, 60), (40, 150)])
def test_random_lp_matches_scipy(rng, m, n):
    A, b, c = random_lp(rng, m, n)
    ref = scipy_opt(A, b, c)
    sol = abip.solve_lp(A, b, c, eps=1e-6, verbose=False)
    assert sol.status_name in ("Solved", "Solved/Inaccurate"), sol.status_name
    assert sol.pobj == pytest.approx(ref, abs=1e-4 * (1 + abs(ref)))
    # primal feasibility in original units
    assert np.linalg.norm(A @ sol.x - b) < 1e-4 * (1 + np.linalg.norm(b))
    assert sol.x.min() > -1e-6


def test_lp_no_normalize(rng):
    A, b, c = random_lp(rng, 15, 45)
    ref = scipy_opt(A, b, c)
    sol = abip.solve_lp(A, b, c, eps=1e-6, normalize=False)
    assert sol.status_name in ("Solved", "Solved/Inaccurate")
    assert sol.pobj == pytest.approx(ref, abs=1e-4 * (1 + abs(ref)))


def test_lp_cg_backend(rng):
    A, b, c = random_lp(rng, 15, 45)
    ref = scipy_opt(A, b, c)
    sol = abip.solve_lp(A, b, c, eps=1e-6, linsys="cg")
    assert sol.status_name in ("Solved", "Solved/Inaccurate")
    assert sol.pobj == pytest.approx(ref, abs=1e-4 * (1 + abs(ref)))


def test_duality_gap(rng):
    A, b, c = random_lp(rng, 12, 40)
    sol = abip.solve_lp(A, b, c, eps=1e-6)
    # complementary slackness: x,s >= 0 and x's ~ 0
    assert abs(sol.pobj - sol.dobj) < 1e-4 * (1 + abs(sol.pobj))
    assert np.dot(np.abs(sol.x), np.abs(sol.s)) < 1e-2


def test_infeasible_lp(rng):
    # x1 + x2 = 1, x1 + x2 = 3 is infeasible over x >= 0
    A = np.array([[1.0, 1.0], [1.0, 1.0]])
    b = np.array([1.0, 3.0])
    c = np.array([1.0, 1.0])
    sol = abip.solve_lp(A, b, c, eps=1e-6)
    assert "Infeasible" in sol.status_name


def test_unbounded_lp():
    # min -x1, s.t. x1 - x2 = 0, x >= 0: x1 = x2 -> infinity
    A = np.array([[1.0, -1.0]])
    b = np.array([0.0])
    c = np.array([-1.0, 0.0])
    sol = abip.solve_lp(A, b, c, eps=1e-6)
    assert "Unbounded" in sol.status_name


def test_sparse_lp_matches_dense(rng):
    import scipy.sparse as sp

    m, n = 30, 200
    Ad = rng.standard_normal((m, n)) * (rng.random((m, n)) < 0.08)
    Ad[np.arange(m), rng.integers(0, n, m)] += 1.0
    b = Ad @ (rng.random(n) + 0.5)
    c = Ad.T @ rng.standard_normal(m) + rng.random(n) + 0.5
    ref = scipy_opt(Ad, b, c)
    A = sp.csr_matrix(Ad)
    s_direct = abip.solve_lp(A, b, c, eps=1e-5)
    s_cg = abip.solve_lp(A, b, c, eps=1e-5, linsys="cg")
    s_dense = abip.solve_lp(Ad, b, c, eps=1e-5)
    for s in (s_direct, s_cg, s_dense):
        assert s.status_name.startswith("Solved")
        assert s.pobj == pytest.approx(ref, abs=1e-3 * (1 + abs(ref)))
    # same equilibration -> identical trajectories
    assert s_direct.admm_iters == s_dense.admm_iters


def test_sigint_returns_best_effort(rng):
    import os
    import signal
    import threading

    # eps far below f64-attainable so the solve cannot finish before the
    # signal fires; a short identical-settings warmup first so the timed
    # run starts iterating immediately instead of JIT-compiling when the
    # signal lands (ADVICE round 1).
    A, b, c = random_lp(rng, 40, 300)
    abip.solve_lp(A, b, c, eps=1e-18, max_ipm_iters=2)
    threading.Timer(1.5, lambda: os.kill(os.getpid(), signal.SIGINT)).start()
    sol = abip.solve_lp(A, b, c, eps=1e-18, max_ipm_iters=100000)
    assert sol.status == abip.Status.SIGINT
    assert sol.status_name == "Interrupted"
    assert np.isfinite(sol.x).all()
    assert np.isfinite(sol.pobj)


def test_hilbert_ill_conditioned():
    from benchmarks.generate import hilbert_lp

    A, b, c = hilbert_lp(n=60, shift=0.5, seed=1)
    ref = scipy_opt(A, b, c)
    sol = abip.solve_lp(A, b, c, eps=1e-6)
    assert sol.status_name.startswith("Solved")
    assert sol.pobj == pytest.approx(ref, abs=1e-3 * (1 + abs(ref)))


@pytest.mark.parametrize("kw", [
    dict(half_update=True, adaptive=False),
    dict(origin_rescale=True, qp_rescale=True),
    dict(pfeasopt=True),
])
def test_settings_variants_solve(rng, kw):
    A, b, c = random_lp(rng, 12, 36)
    ref = scipy_opt(A, b, c)
    sol = abip.solve_lp(A, b, c, eps=1e-5, **kw)
    assert sol.status_name.startswith("Solved")
    assert sol.pobj == pytest.approx(ref, abs=1e-2 * (1 + abs(ref)))


def test_tight_tolerance_1e8(rng):
    # the reference benchmarks at eps in {1e-4, 1e-6, 1e-8}
    A, b, c = random_lp(rng, 15, 45)
    ref = scipy_opt(A, b, c)
    sol = abip.solve_lp(A, b, c, eps=1e-8)
    assert sol.status_name == "Solved"
    assert sol.res_pri < 1e-8 and sol.rel_gap < 1e-8
    assert sol.pobj == pytest.approx(ref, abs=1e-6 * (1 + abs(ref)))


def test_pagerank_scattered_sparse(rng):
    """ELL layout path: scattered-sparsity LP solved via CG, checked
    against power iteration."""
    import scipy.sparse as sp

    n, deg = 2000, 6
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, n * deg)
    P = sp.csr_matrix((np.ones(n * deg), (rows, cols)), shape=(n, n))
    P = sp.diags(1.0 / np.maximum(np.asarray(P.sum(axis=1)).ravel(), 1)) @ P
    A = (sp.eye(n) - 0.85 * P.T).tocsr()
    b = 0.15 / n * np.ones(n)
    c = np.ones(n)

    from abip.problem import LinearOperator

    op = LinearOperator.from_scipy_sparse(A)
    assert hasattr(op, "ell"), "auto layout should pick ELL for scattered A"

    sol = abip.solve_lp(A, b, c, eps=1e-6, linsys="cg", adaptive=False)
    assert sol.status_name.startswith("Solved")
    v = np.ones(n) / n
    for _ in range(200):
        v = 0.85 * (P.T @ v) + 0.15 / n
    assert np.abs(sol.x - v).max() < 1e-8


def test_pagerank_generator_oracle():
    """pagerank_lp: unique feasible point is the PageRank vector, so the
    LP optimum is exactly 1 (see generator docstring); solve a small one
    through the CG path and check both."""
    import scipy.sparse.linalg as spla

    from benchmarks.generate import pagerank_lp

    A, b, c = pagerank_lp(n=1500, seed=4)
    x_star = spla.spsolve(A.tocsc(), b)
    assert x_star.min() >= 0 and c @ x_star == pytest.approx(1.0, abs=1e-10)

    sol = abip.solve_lp(A, b, c, eps=1e-6, linsys="cg", adaptive=False)
    assert sol.status_name.startswith("Solved")
    assert sol.pobj == pytest.approx(1.0, abs=1e-5)
    assert np.abs(sol.x - x_star).max() < 1e-6


def test_solve_general_two_sided_and_boxed():
    """First-class general-form API (no MPS file): two-sided rows, boxed
    variables, maximize + objective constant, vs scipy."""
    from scipy.optimize import linprog

    from abip.dispatch import solve_general

    rng = np.random.default_rng(0)
    m, n = 12, 20
    A = rng.standard_normal((m, n))
    row_hi = A @ rng.standard_normal(n) + rng.random(m)
    lb, ub = np.full(n, -2.0), np.full(n, 3.0)
    c = rng.standard_normal(n)

    sol = solve_general(A, c, row_hi=row_hi, lb=lb, ub=ub, eps=1e-6)
    ref = linprog(c, A_ub=A, b_ub=row_hi,
                  bounds=np.column_stack([lb, ub]), method="highs")
    assert sol.status_name == "Solved"
    assert abs(sol.pobj - ref.fun) < 1e-5 * (1 + abs(ref.fun))

    sol2 = solve_general(A, c, row_hi=row_hi, lb=lb, ub=ub,
                         objcon=5.0, maximize=True, eps=1e-6)
    ref2 = linprog(-c, A_ub=A, b_ub=row_hi,
                   bounds=np.column_stack([lb, ub]), method="highs")
    want = -ref2.fun + 5.0
    assert abs(sol2.pobj - want) < 1e-5 * (1 + abs(want))
