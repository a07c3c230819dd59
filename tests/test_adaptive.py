"""Adaptive-beta (Barzilai-Borwein) and warm-start tests."""
import numpy as np
import pytest
from scipy.optimize import linprog

import abip
from tests.conftest import random_lp


def test_adaptive_converges(rng):
    A, b, c = random_lp(rng, 15, 45)
    ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, None), method="highs").fun
    sol = abip.solve_lp(A, b, c, eps=1e-6, adaptive=True)
    assert sol.status_name in ("Solved", "Solved/Inaccurate")
    assert sol.pobj == pytest.approx(ref, abs=1e-4 * (1 + abs(ref)))


def test_adaptive_vs_fixed_beta(rng):
    # adaptive should not blow up iteration counts vs fixed beta
    A, b, c = random_lp(rng, 12, 36)
    s1 = abip.solve_lp(A, b, c, eps=1e-6, adaptive=False)
    s2 = abip.solve_lp(A, b, c, eps=1e-6, adaptive=True)
    assert s1.status_name.startswith("Solved")
    assert s2.status_name.startswith("Solved")
    assert s2.admm_iters <= 5 * max(1, s1.admm_iters)


def test_warm_start_converges(rng):
    # The barrier path restarts at mu=1 either way (as in the reference),
    # so warm starting buys factorization reuse rather than fewer
    # iterations -- assert correct convergence and comparable work.
    A, b, c = random_lp(rng, 15, 45)
    from abip.lp import LPWorkspace

    w = LPWorkspace(A, b, c, abip.Settings(eps=1e-6))
    cold = w.solve()
    assert cold.status_name.startswith("Solved")
    w2 = LPWorkspace(A, b, c, abip.Settings(eps=1e-6))
    hot = w2.solve(warm=(cold.x, cold.y, cold.s))
    assert hot.status_name.startswith("Solved")
    assert hot.pobj == pytest.approx(cold.pobj, abs=1e-4 * (1 + abs(cold.pobj)))
    assert hot.admm_iters <= 3 * cold.admm_iters


def test_warm_start_bad_shapes(rng):
    A, b, c = random_lp(rng, 10, 30)
    from abip.lp import LPWorkspace

    w = LPWorkspace(A, b, c, abip.Settings(eps=1e-4))
    with pytest.raises(ValueError, match="warm start"):
        w.solve(warm=(np.ones(5), np.ones(10), np.ones(30)))


def test_update_problem_reuses_factorization(rng):
    """The init/solve split: new b, c with the same A (reference
    `include/abip.h:116-123` seam) -- correct and without recompiles."""
    from abip.lp import LPWorkspace

    A, b1, c1 = random_lp(rng, 12, 36)
    w = LPWorkspace(A, b1, c1, abip.Settings(eps=1e-6, adaptive=False))
    s1 = w.solve()
    assert s1.status_name.startswith("Solved")
    # new b, c must be constructed for the SAME A to stay solvable
    b2 = A @ (rng.random(36) + 0.5)
    c2 = A.T @ rng.standard_normal(12) + rng.random(36) + 0.5
    w.update_problem(b2, c2)
    s2 = w.solve()
    ref2 = linprog(c2, A_eq=A, b_eq=b2, bounds=(0, None), method="highs").fun
    assert s2.status_name.startswith("Solved")
    assert s2.pobj == pytest.approx(ref2, abs=1e-4 * (1 + abs(ref2)))
    with pytest.raises(ValueError, match="shapes"):
        w.update_problem(b2[:-1], c2)
