"""mip17-mini: MIPLIB-relaxation-style combinatorial LPs round-trip
through MPS and solve to tolerance vs the HiGHS oracle."""
import numpy as np
import pytest
from scipy.optimize import linprog

from benchmarks.mip17_mini import MANIFEST


@pytest.mark.parametrize("name", ["pack01", "assign01", "facloc01",
                                  "cstock01"])
def test_mip17_instance_solves(name, tmp_path):
    from abip.io.mps_write import write_mps
    from abip.io.presolve import solve_mps

    p = MANIFEST[name]()
    path = tmp_path / f"{name}.mps"
    write_mps(p, str(path))
    sol, _ = solve_mps(str(path), eps=1e-6)
    assert sol.status_name == "Solved"

    # HiGHS on the general form directly
    A = p.A.toarray()
    eq = p.row_lo == p.row_hi
    le = ~eq & np.isfinite(p.row_hi)
    ge = ~eq & np.isfinite(p.row_lo)
    A_ub = np.concatenate([A[le], -A[ge]]) if (le.any() or ge.any()) else None
    b_ub = np.concatenate([p.row_hi[le], -p.row_lo[ge]]) \
        if A_ub is not None else None
    sgn = -1.0 if p.maximize else 1.0
    ref = linprog(sgn * p.c, A_eq=A[eq] if eq.any() else None,
                  b_eq=p.row_hi[eq] if eq.any() else None,
                  A_ub=A_ub, b_ub=b_ub,
                  bounds=np.column_stack([p.lb, p.ub]), method="highs")
    want = sgn * ref.fun
    assert abs(sol.pobj - want) < 1e-4 * (1 + abs(want))
