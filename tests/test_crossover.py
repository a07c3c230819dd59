"""Crossover (vertex polish): exact-basis certificates from interior
points.  Native analogue of `scripts/bench-lp/crossover_by_copt.py`."""
import numpy as np
import pytest
from scipy.optimize import linprog

import abip
from abip.crossover import crossover


def random_lp(seed, m=25, n=80):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    b = A @ (rng.random(n) + 0.5)
    c = A.T @ rng.standard_normal(m) + rng.random(n) + 0.5
    return A, b, c


@pytest.mark.parametrize("seed", [0, 3, 5])
def test_crossover_certifies_vertex(seed):
    A, b, c = random_lp(seed)
    sol = abip.solve_lp(A, b, c, eps=1e-6)
    cr = crossover(A, b, c, sol.x)
    ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, None), method="highs")
    assert cr.optimal
    # the polished vertex matches the simplex optimum to machine precision
    assert abs(cr.pobj - ref.fun) < 1e-9 * (1 + abs(ref.fun))
    assert abs(cr.pobj - cr.dobj) < 1e-9 * (1 + abs(cr.pobj))
    assert cr.primal_feas < 1e-10
    assert len(np.unique(cr.basis)) == A.shape[0]


def test_crossover_from_pdhg():
    """Works from any eps-accurate interior point, not just ABIP's."""
    A, b, c = random_lp(7, 30, 90)
    sol = abip.solve_lp_pdhg(A, b, c, eps=1e-6)
    cr = crossover(A, b, c, sol.x)
    ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, None), method="highs")
    assert cr.optimal
    assert abs(cr.pobj - ref.fun) < 1e-9 * (1 + abs(ref.fun))


def test_crossover_suite_flag(tmp_path):
    """run_suite --mps --crossover records the certificate fields."""
    import scipy.sparse as sp

    from abip.io.mps import GeneralLP
    from abip.io.mps_write import write_mps
    from benchmarks.run_suite import run_mps

    A, b, c = random_lp(11, 10, 30)
    p = GeneralLP(c=c, A=sp.csc_matrix(A), row_lo=b, row_hi=b,
                  lb=np.zeros(30), ub=np.full(30, np.inf))
    write_mps(p, str(tmp_path / "x.mps"))
    recs = run_mps([str(tmp_path / "x.mps")], 1e-6, None, crossover=True)
    assert recs[0]["crossover_optimal"] is True
    assert abs(recs[0]["pobj_vertex"] - recs[0]["pobj"]) < 1e-4


def test_run_mps_threads(tmp_path):
    """run_suite --threads: concurrent instances keep record order and
    correctness (host_pool under the suite runner)."""
    import scipy.sparse as sp

    from abip.io.mps import GeneralLP
    from abip.io.mps_write import write_mps
    from benchmarks.run_suite import run_mps

    paths, refs = [], []
    for i in range(3):
        A, b, c = random_lp(20 + i, 8, 24)
        p = GeneralLP(c=c, A=sp.csc_matrix(A), row_lo=b, row_hi=b,
                      lb=np.zeros(24), ub=np.full(24, np.inf))
        path = str(tmp_path / f"t{i}.mps")
        write_mps(p, path)
        paths.append(path)
        refs.append(linprog(c, A_eq=A, b_eq=b, bounds=(0, None),
                            method="highs").fun)
    recs = run_mps(paths, 1e-6, None, threads=3)
    assert [r["name"] for r in recs] == [f"t{i}" for i in range(3)]
    for r, ref in zip(recs, refs):
        assert r["status"].startswith("Solved")
        assert abs(r["pobj"] - ref) < 1e-3 * (1 + abs(ref))
