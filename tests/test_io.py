"""IO tests: MPS parsing + presolve roundtrip against scipy on the same LP."""
import textwrap

import numpy as np
import pytest
from scipy.optimize import linprog

from abip.io import read_mps, presolve_to_standard
from abip.io.presolve import solve_mps

SAMPLE_MPS = textwrap.dedent("""\
    * a small general-form LP exercising E/L/G rows, RANGES and BOUNDS
    NAME          SAMPLE
    ROWS
     N  COST
     E  R1
     L  R2
     G  R3
     L  R4
    COLUMNS
        X1  COST  1.0   R1  1.0
        X1  R2    2.0   R3  1.0
        X2  COST  2.0   R1  1.0
        X2  R4    1.0
        X3  COST  -1.0  R2  1.0
        X3  R3    1.0   R4  1.0
    RHS
        RHS  R1  4.0   R2  10.0
        RHS  R3  1.0   R4  6.0
    RANGES
        RNG  R2  4.0
    BOUNDS
     UP BND  X1  8.0
     LO BND  X2  -2.0
     FR BND  X3
    ENDATA
    """)


def scipy_solve(p):
    # scipy linprog on the general form: build [lo <= Ax <= hi] as A_ub/A_eq
    A = p.A.toarray()
    A_eq, b_eq, A_ub, b_ub = [], [], [], []
    for i in range(A.shape[0]):
        lo, hi = p.row_lo[i], p.row_hi[i]
        if lo == hi:
            A_eq.append(A[i]); b_eq.append(hi)
        else:
            if np.isfinite(hi):
                A_ub.append(A[i]); b_ub.append(hi)
            if np.isfinite(lo):
                A_ub.append(-A[i]); b_ub.append(-lo)
    res = linprog(
        (-1 if p.maximize else 1) * p.c,
        A_eq=np.array(A_eq) if A_eq else None,
        b_eq=np.array(b_eq) if b_eq else None,
        A_ub=np.array(A_ub) if A_ub else None,
        b_ub=np.array(b_ub) if b_ub else None,
        bounds=list(zip(p.lb, p.ub)),
        method="highs",
    )
    assert res.status == 0, res.message
    sign = -1 if p.maximize else 1
    return sign * res.fun + p.objcon


@pytest.fixture
def sample_path(tmp_path):
    f = tmp_path / "sample.mps"
    f.write_text(SAMPLE_MPS)
    return str(f)


def test_parse_sample(sample_path):
    p = read_mps(sample_path)
    assert p.name == "SAMPLE"
    assert p.col_names == ["X1", "X2", "X3"]
    assert p.row_names == ["R1", "R2", "R3", "R4"]
    np.testing.assert_allclose(p.c, [1.0, 2.0, -1.0])
    # R2: L 10 with range 4 -> [6, 10]
    np.testing.assert_allclose(p.row_lo, [4.0, 6.0, 1.0, -np.inf])
    np.testing.assert_allclose(p.row_hi, [4.0, 10.0, np.inf, 6.0])
    np.testing.assert_allclose(p.lb, [0.0, -2.0, -np.inf])
    np.testing.assert_allclose(p.ub, [8.0, np.inf, np.inf])


def test_presolve_matches_scipy(sample_path):
    p = read_mps(sample_path)
    ref = scipy_solve(p)
    std = presolve_to_standard(p)
    # solve the standard form with scipy and map the objective back
    res = linprog(std.c, A_eq=std.A.toarray(), b_eq=std.b,
                  bounds=(0, None), method="highs")
    assert res.status == 0
    assert std.user_objective(res.fun) == pytest.approx(ref, abs=1e-6)


def test_solve_mps_end_to_end(sample_path):
    p = read_mps(sample_path)
    ref = scipy_solve(p)
    sol, std = solve_mps(sample_path, eps=1e-6)
    assert sol.status_name in ("Solved", "Solved/Inaccurate")
    assert sol.pobj == pytest.approx(ref, abs=1e-3 * (1 + abs(ref)))
    # recovered x respects the original bounds
    assert (sol.x >= p.lb - 1e-5).all()
    assert (sol.x <= p.ub + 1e-5).all()


def test_maximize_objsense(tmp_path):
    mps = SAMPLE_MPS.replace("NAME          SAMPLE",
                             "NAME          SAMPLE\nOBJSENSE\n    MAX")
    f = tmp_path / "max.mps"
    f.write_text(mps)
    p = read_mps(str(f))
    assert p.maximize
    ref = scipy_solve(p)
    sol, _ = solve_mps(str(f), eps=1e-6)
    assert sol.pobj == pytest.approx(ref, abs=1e-3 * (1 + abs(ref)))


def test_integer_marker_rejected(tmp_path):
    mps = SAMPLE_MPS.replace(
        "    X1  COST  1.0   R1  1.0",
        "    M1  'MARKER'  'INTORG'\n    X1  COST  1.0   R1  1.0",
    )
    f = tmp_path / "int.mps"
    f.write_text(mps)
    with pytest.raises(ValueError, match="continuous"):
        read_mps(str(f))


def test_bounds_without_set_name(tmp_path):
    """3-token BOUNDS lines 'BTYPE COL VAL' (no set name) must apply the
    bound, not silently drop it (ADVICE round 1)."""
    mps = SAMPLE_MPS.replace(
        " UP BND  X1  8.0\n LO BND  X2  -2.0\n FR BND  X3\n",
        " UP X1  8.0\n LO X2  -2.0\n FR X3\n",
    )
    f = tmp_path / "noset.mps"
    f.write_text(mps)
    p = read_mps(str(f))
    np.testing.assert_allclose(p.lb, [0.0, -2.0, -np.inf])
    np.testing.assert_allclose(p.ub, [8.0, np.inf, np.inf])


def test_bounds_missing_value_raises(tmp_path):
    mps = SAMPLE_MPS.replace(" UP BND  X1  8.0", " UP BND  X1")
    f = tmp_path / "noval.mps"
    f.write_text(mps)
    with pytest.raises(ValueError, match="requires a value"):
        read_mps(str(f))


def test_bounds_unknown_column_raises(tmp_path):
    mps = SAMPLE_MPS.replace(" UP BND  X1  8.0", " UP BND  NOPE  8.0")
    f = tmp_path / "unkcol.mps"
    f.write_text(mps)
    with pytest.raises(ValueError, match="unknown column"):
        read_mps(str(f))


def test_pad_standard_preserves_solution(tmp_path):
    """Bucket padding (singleton rows, +1-objective columns) leaves the
    recovered solution and user objective unchanged."""
    import scipy.sparse as sp
    from scipy.optimize import linprog

    from abip.io.mps import GeneralLP
    from abip.io.presolve import (pad_standard, presolve_to_standard,
                                      solve_mps)
    from abip.io.mps_write import write_mps

    rng = np.random.default_rng(2)
    m, n = 11, 30
    A = rng.standard_normal((m, n))
    b = A @ (rng.random(n) + 0.5)
    c = A.T @ rng.standard_normal(m) + rng.random(n) + 0.5
    p = GeneralLP(c=c, A=sp.csc_matrix(A), row_lo=b, row_hi=b,
                  lb=np.zeros(n), ub=np.full(n, np.inf))
    std = presolve_to_standard(p)
    padded = pad_standard(std, 64)
    assert padded.A.shape[0] % 64 == 0
    assert padded.A.shape[0] > std.A.shape[0]

    path = str(tmp_path / "pad.mps")
    write_mps(p, path)
    sol, _ = solve_mps(path, eps=1e-6, pad_bucket=64)
    ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, None), method="highs")
    assert sol.status_name == "Solved"
    assert abs(sol.pobj - ref.fun) < 1e-5 * (1 + abs(ref.fun))
    assert sol.x.shape == (n,)
    assert np.linalg.norm(A @ sol.x - b) < 1e-5 * (1 + np.linalg.norm(b))


def test_save_presolved_mps_preserves_user_objective(tmp_path):
    """The saved standard-form file must report the same user objective as
    the original: OBJSENSE and the presolve shift/objective constant are
    folded into the written file's cost/objcon (review round 2)."""
    from abip.io.presolve import save_presolved_mps

    mps = SAMPLE_MPS.replace("NAME          SAMPLE",
                             "NAME          SAMPLE\nOBJSENSE\n    MAX")
    # RHS on the objective row: objcon = -3.0
    mps = mps.replace("    RHS  R1  4.0", "    RHS  COST  3.0   R1  4.0")
    f = tmp_path / "orig.mps"
    f.write_text(mps)
    p = read_mps(str(f))
    assert p.maximize and p.objcon == -3.0
    ref = scipy_solve(p)
    out = tmp_path / "presolved.mps"
    save_presolved_mps(str(f), str(out))
    sol, _ = solve_mps(str(out), eps=1e-6)
    assert sol.status_name in ("Solved", "Solved/Inaccurate")
    assert sol.pobj == pytest.approx(ref, abs=1e-3 * (1 + abs(ref)))
