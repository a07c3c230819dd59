"""netlib-mini suite: MPS writer round-trip + end-to-end solves at 1e-6.

Covers the reference's benchmark-as-test protocol (`test_one_abip.m:29-37`)
on the generated stand-in suite: every instance goes through
write_mps -> read_mps (Python AND native C++) -> presolve -> solve ->
recover, and the objective is checked against scipy linprog (HiGHS) on the
parsed general form.
"""
import numpy as np
import pytest
from scipy.optimize import linprog

from abip.io.mps import read_mps
from abip.io.mps_write import write_mps
from abip.io.presolve import solve_mps
from benchmarks.netlib_mini import MANIFEST

from tests.test_io import scipy_solve


NAMES = sorted(MANIFEST)


@pytest.mark.parametrize("name", NAMES)
def test_roundtrip(name, tmp_path):
    p = MANIFEST[name]()
    path = str(tmp_path / f"{name}.mps")
    write_mps(p, path)
    q = read_mps(path, prefer_native="never")
    assert q.maximize == p.maximize
    np.testing.assert_allclose(q.c, p.c, rtol=0, atol=0)
    np.testing.assert_allclose(q.row_lo, p.row_lo)
    np.testing.assert_allclose(q.row_hi, p.row_hi)
    np.testing.assert_allclose(q.lb, p.lb)
    np.testing.assert_allclose(q.ub, p.ub)
    np.testing.assert_allclose(q.A.toarray(), p.A.toarray())


def test_roundtrip_native(tmp_path):
    from abip.io.native import native_available, read_mps_native

    if not native_available():
        pytest.skip("native parser not built")
    p = MANIFEST["prod01"]()
    path = str(tmp_path / "prod01.mps")
    write_mps(p, path)
    q = read_mps_native(path)
    np.testing.assert_allclose(q.A.toarray(), p.A.toarray())
    np.testing.assert_allclose(q.lb, p.lb)
    np.testing.assert_allclose(q.row_lo, p.row_lo)


@pytest.mark.parametrize("name", NAMES)
def test_solve_to_1e6(name, tmp_path):
    p = MANIFEST[name]()
    ref = scipy_solve(p)
    path = str(tmp_path / f"{name}.mps")
    write_mps(p, path)
    sol, _ = solve_mps(path, eps=1e-6)
    assert sol.status_name.startswith("Solved"), (name, sol.status_name)
    assert sol.pobj == pytest.approx(ref, abs=1e-4 * (1 + abs(ref))), name


def test_solve_device_route(tmp_path):
    """solve_mps(method='device') routes through device_solve_lp (whole
    solve as one program; the `run_suite --mps --method device` path)
    and matches the scipy-HiGHS oracle."""
    for name in ("prod01", "tran01"):
        p = MANIFEST[name]()
        ref = scipy_solve(p)
        path = str(tmp_path / f"{name}.mps")
        write_mps(p, path)
        sol, _ = solve_mps(path, eps=1e-6, method="device")
        assert sol.status_name.startswith("Solved"), (name, sol.status_name)
        assert sol.pobj == pytest.approx(ref, abs=1e-4 * (1 + abs(ref))), name
