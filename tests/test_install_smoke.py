"""The reference's own install acceptance test, through our front door.

`/root/reference/test/test_abip_install.m:7-43` checks two problems:
a random LP `A=[sprand(50,2000,0.3), I], b=rand, c=rand` and a tiny QCP
with Q=I over one SOC(3) x RSOC(3) x free x nonneg.  This re-derives
both in our API (same shapes/cone structure, our RNG) and checks
against scipy oracles -- the exact migration path a reference user
takes.
"""
import numpy as np
import pytest

import abip
from abip import ConeSpec


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    import jax

    jax.config.update("jax_platforms", "cpu")


def test_install_lp_shape():
    rng = np.random.default_rng(24)
    m, n = 50, 2000
    Ar = rng.standard_normal((m, n)) * (rng.random((m, n)) < 0.3)
    A = np.concatenate([Ar, np.eye(m)], axis=1)
    b = rng.random(m)
    c = rng.random(m + n)
    sol = abip.solve(A, b, c, eps=1e-6)
    assert sol.status_name == "Solved"
    from scipy.optimize import linprog

    ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, None), method="highs")
    assert abs(sol.pobj - ref.fun) / (1 + abs(ref.fun)) < 1e-5


def test_install_qcp_toy():
    """The exact cone structure of the reference toy: SOC(3) x RSOC(3)
    x free(1) x nonneg(1), Q = I, 2 equality rows (same variable
    ordering as `solve_barrier_subproblem`, `source/abip.c:358-409`)."""
    A = np.array([[1.0, 2, 3, 4, 5, 6, 7, 8],
                  [0.0, 1, 2, 1, 2, 3, 1, 2]])
    b = np.array([4.0, 3.0])
    c = np.array([1.0, 0, 2, 1, 4, 2, 3, 0])
    Q = np.eye(8)
    cones = ConeSpec(soc=(3,), rsoc=(3,), free=1, nonneg=1)
    sol = abip.solve(A, b, c, cones=cones, Q=Q, eps=1e-7)
    assert sol.status_name == "Solved"

    # oracle: SLSQP on the smooth reformulation of the cone constraints
    from scipy.optimize import minimize

    def f(x):
        return 0.5 * x @ Q @ x + c @ x

    cons = [
        {"type": "eq", "fun": lambda x: A @ x - b},
        # SOC(3): x0^2 >= x1^2 + x2^2, x0 >= 0 (squared, smooth)
        {"type": "ineq",
         "fun": lambda x: x[0] ** 2 - x[1] ** 2 - x[2] ** 2},
        {"type": "ineq", "fun": lambda x: x[0]},
        # RSOC(3): 2 x3 x4 >= x5^2, x3, x4 >= 0
        {"type": "ineq", "fun": lambda x: 2 * x[3] * x[4] - x[5] ** 2},
        {"type": "ineq", "fun": lambda x: x[3]},
        {"type": "ineq", "fun": lambda x: x[4]},
        # x6 free; x7 >= 0
        {"type": "ineq", "fun": lambda x: x[7]},
    ]
    # The squared-cone description is NONCONVEX, so SLSQP multistart can
    # sit at spurious KKT points; the sound oracle is three-part:
    # (1) our solution must be at least as good as SLSQP's multistart,
    # (2) SLSQP refined FROM our x must not improve it materially
    #     (local optimality at a feasible point of a convex problem
    #     == global optimality), and (3) feasibility + cone membership,
    #     asserted below.
    best = None
    for s in range(6):
        x0 = np.abs(np.random.default_rng(s).standard_normal(8)) + 0.1
        r = minimize(f, x0, constraints=cons, method="SLSQP",
                     options={"maxiter": 800, "ftol": 1e-14})
        if r.success and (best is None or r.fun < best):
            best = r.fun
    assert best is not None
    assert sol.pobj <= best + 1e-4 * (1 + abs(best))
    refined = minimize(f, sol.x, constraints=cons, method="SLSQP",
                       options={"maxiter": 2000, "ftol": 1e-16})
    assert refined.fun >= sol.pobj - 1e-5 * (1 + abs(sol.pobj))

    # primal feasibility + cone membership of our solution
    from abip.cones import ConeLayout, cone_membership_violation
    import jax.numpy as jnp

    assert np.linalg.norm(A @ sol.x - b) < 1e-5
    assert float(cone_membership_violation(
        jnp.asarray(sol.x), ConeLayout(cones))) < 1e-6


def test_nonfinite_data_rejected():
    """NaN/inf data must raise at validation (`abip.c:1646-1734` role),
    not surface as a bogus Unbounded exit (LP) or a long futile inner
    loop (conic -- NaN comparisons are all False)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(0)
    A = rng.standard_normal((4, 10))
    b = A @ (rng.random(10) + 0.5)
    c = rng.random(10)
    An = A.copy()
    An[1, 2] = np.nan
    with pytest.raises(ValueError, match="A contains"):
        abip.solve_lp(An, b, c)
    with pytest.raises(ValueError, match="A contains"):
        abip.solve_lp(sp.csr_matrix(An), b, c)
    with pytest.raises(ValueError, match="b contains"):
        abip.solve_lp(A, np.r_[b[:-1], np.inf], c)
    with pytest.raises(ValueError, match="A contains"):
        abip.solve_qcp(An, b, c, ConeSpec.lp(10))
    with pytest.raises(ValueError, match="Q contains"):
        Q = np.eye(10)
        Q[0, 0] = np.nan
        abip.solve_qcp(A, b, c, ConeSpec.lp(10), Q=Q)


def test_edge_shapes_and_scaling():
    """Edges the reference mishandles or rejects: tall A (m > n --
    rejected outright at `abip.c:1661-1665`; we solve it), 1e14 dynamic
    range (equilibration), zero rhs, and a 1x1 LP."""
    from scipy.optimize import linprog

    rng = np.random.default_rng(3)
    A = rng.standard_normal((30, 10))
    b = A @ (rng.random(10) + 0.5)
    c = rng.random(10)
    s = abip.solve_lp(A, b, c, eps=1e-6)
    ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, None), method="highs")
    assert s.status_name == "Solved"
    assert abs(s.pobj - ref.fun) / (1 + abs(ref.fun)) < 1e-4

    A2 = rng.standard_normal((5, 40)) * 1e8
    A2[:, :5] += np.eye(5) * 1e-6
    b2 = A2 @ (rng.random(40) + 0.5)
    c2 = rng.random(40) * 1e6
    s = abip.solve_lp(A2, b2, c2, eps=1e-6)
    ref = linprog(c2, A_eq=A2, b_eq=b2, bounds=(0, None), method="highs")
    assert s.status_name == "Solved"
    assert abs(s.pobj - ref.fun) / (1 + abs(ref.fun)) < 1e-4

    A3 = rng.standard_normal((4, 12))
    s = abip.solve_lp(A3, np.zeros(4), rng.random(12) + 0.1, eps=1e-6)
    assert s.status_name == "Solved" and abs(s.pobj) < 1e-6

    s = abip.solve_lp(np.array([[2.0]]), np.array([4.0]),
                          np.array([3.0]), eps=1e-8)
    assert abs(s.pobj - 6.0) < 1e-5
