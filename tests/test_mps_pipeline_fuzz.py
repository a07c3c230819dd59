"""End-to-end MPS pipeline fuzz.

Random general-form LPs (mixed row senses incl. ranges, variable bound
classes incl. free/negative/fixed, MAX sense, objective constants) are
pushed through the FULL chain:

    GeneralLP -> write_mps -> read_mps (Python AND native C++ parser)
             -> presolve_to_standard -> solve -> user-objective recovery

and the recovered optimum is checked against scipy linprog solving the
ORIGINAL general form directly -- one oracle covering the writer, both
parsers, the presolve bookkeeping, and the solver.
"""
import numpy as np
import pytest

from abip.io.mps import read_mps
from abip.io.mps_write import write_mps
from abip.io.presolve import presolve_to_standard


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    import jax

    jax.config.update("jax_platforms", "cpu")


def random_general_lp(seed, m=12, n=18):
    """General-form LP with every row/bound class, guaranteed feasible
    (rows/bounds are placed around a strictly interior point x0)."""
    import scipy.sparse as sp

    from abip.io.mps import GeneralLP

    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) * (rng.random((m, n)) < 0.6)
    A[A.sum(axis=1) == 0, 0] = 1.0          # no empty rows
    x0 = rng.uniform(-1.0, 2.0, n)
    r = A @ x0
    kinds = rng.integers(0, 4, m)           # 0 eq, 1 le, 2 ge, 3 range
    row_lo = np.where(kinds == 0, r, np.where(
        kinds == 2, r - rng.random(m) - 0.1,
        np.where(kinds == 3, r - rng.random(m) - 0.1, -np.inf)))
    row_hi = np.where(kinds == 0, r, np.where(
        kinds == 1, r + rng.random(m) + 0.1,
        np.where(kinds == 3, r + rng.random(m) + 0.1, np.inf)))

    # 0 [0,inf) 1 [lo,inf) 2 free 3 [lo,hi] 4 fixed -- free kept rare so
    # most random instances stay bounded (unbounded ones are skipped)
    bk = rng.choice(5, n, p=[0.3, 0.2, 0.1, 0.25, 0.15])
    lb = np.where(bk == 0, 0.0, np.where(
        bk == 1, x0 - rng.random(n) - 0.1,  # 3 [lo,hi] 4 fixed
        np.where(bk == 2, -np.inf,
                 np.where(bk == 3, x0 - rng.random(n) - 0.1, x0))))
    ub = np.where(bk == 3, x0 + rng.random(n) + 0.1,
                  np.where(bk == 4, x0, np.inf))
    lb = np.minimum(lb, x0)                 # keep x0 feasible
    c = rng.standard_normal(n)
    return GeneralLP(c=c, A=sp.csc_matrix(A), row_lo=row_lo,
                     row_hi=row_hi, lb=lb, ub=ub,
                     objcon=float(rng.standard_normal()),
                     maximize=bool(seed % 2), name=f"fuzz{seed}")


def scipy_general(p):
    from scipy.optimize import linprog

    A = p.A.toarray()
    eq = np.isfinite(p.row_lo) & np.isfinite(p.row_hi) \
        & (p.row_lo == p.row_hi)
    le = ~eq & np.isfinite(p.row_hi)
    ge = ~eq & np.isfinite(p.row_lo)
    A_ub = np.vstack([A[le], -A[ge]]) if (le.any() or ge.any()) else None
    b_ub = np.concatenate([p.row_hi[le], -p.row_lo[ge]]) \
        if A_ub is not None else None
    sgn = -1.0 if p.maximize else 1.0
    res = linprog(sgn * p.c, A_eq=A[eq] if eq.any() else None,
                  b_eq=p.row_hi[eq] if eq.any() else None,
                  A_ub=A_ub, b_ub=b_ub,
                  bounds=np.column_stack([p.lb, p.ub]), method="highs")
    if res.status != 0:
        return None
    return sgn * res.fun + p.objcon


@pytest.mark.parametrize("seed", range(10))
def test_pipeline_roundtrip(seed, tmp_path):
    import abip
    from abip.io.native import native_available

    p = random_general_lp(seed)
    star = scipy_general(p)
    if star is None:
        pytest.skip("scipy declares the random instance unbounded")
    path = tmp_path / f"f{seed}.mps"
    write_mps(p, str(path))

    parsers = [lambda: read_mps(str(path), prefer_native="never")]
    if native_available():
        parsers.append(lambda: read_mps(str(path), prefer_native="always"))
    objs = []
    for parse in parsers:
        q = parse()
        std = presolve_to_standard(q)
        sol = abip.solve_lp(std.A.toarray(), std.b, std.c, eps=1e-7)
        assert sol.status_name == "Solved", (seed, sol.status_name)
        objs.append(std.user_objective(sol.pobj))
    for obj in objs:
        assert abs(obj - star) / (1 + abs(star)) < 1e-5, (seed, obj, star)
    if len(objs) == 2:   # both parsers fed the same problem
        assert abs(objs[0] - objs[1]) < 1e-9 * (1 + abs(objs[0]))
