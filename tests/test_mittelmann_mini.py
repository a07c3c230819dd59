"""mittelmann-mini: larger staircase/grid-flow/wide-degenerate LPs."""
import numpy as np
import pytest
from scipy.optimize import linprog

from benchmarks.mittelmann_mini import MANIFEST


@pytest.mark.parametrize("name", ["stair01", "grid01"])
def test_mittelmann_instance_solves(name, tmp_path):
    from abip.io.mps_write import write_mps
    from abip.io.presolve import solve_mps

    p = MANIFEST[name]()
    path = tmp_path / f"{name}.mps.gz"      # exercises the gz writer too
    write_mps(p, str(path))
    sol, _ = solve_mps(str(path), eps=1e-6)
    assert sol.status_name == "Solved"

    A = p.A.toarray()
    eq = p.row_lo == p.row_hi
    le = ~eq & np.isfinite(p.row_hi)
    A_ub = A[le] if le.any() else None
    b_ub = p.row_hi[le] if le.any() else None
    ref = linprog(p.c, A_eq=A[eq] if eq.any() else None,
                  b_eq=p.row_hi[eq] if eq.any() else None,
                  A_ub=A_ub, b_ub=b_ub,
                  bounds=np.column_stack([p.lb, p.ub]), method="highs")
    assert abs(sol.pobj - ref.fun) < 1e-4 * (1 + abs(ref.fun))
