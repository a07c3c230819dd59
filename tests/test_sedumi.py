"""SeDuMi loader tests + conic status-classification tests."""
import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp

import abip
from abip import ConeSpec
from abip.io.sedumi import from_sedumi, load_sedumi_mat, solve_sedumi


def test_from_sedumi_permutation(rng):
    # sedumi order [free(2), l(3), q(4)]; ours [q(4), free(2), l(3)]
    m, n = 5, 9
    A = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    c = rng.standard_normal(n)
    K = {"f": 2, "l": 3, "q": [4]}
    A2, b2, c2, cones, perm = from_sedumi(sp.csc_matrix(A), b, c, K)
    assert cones == ConeSpec(soc=(4,), free=2, nonneg=3)
    np.testing.assert_allclose(A2, A[:, perm])
    np.testing.assert_allclose(c2, c[perm])
    # soc columns come first in our order
    np.testing.assert_array_equal(perm[:4], [5, 6, 7, 8])


def test_from_sedumi_dim_mismatch(rng):
    A = sp.csc_matrix(rng.standard_normal((3, 5)))
    with pytest.raises(ValueError, match="do not match"):
        from_sedumi(A, np.zeros(3), np.zeros(5), {"f": 2, "l": 1})


def test_solve_sedumi_mat_roundtrip(rng, tmp_path):
    # SOC norm-min toy written as a sedumi .mat, solved end to end
    a = rng.standard_normal(3)
    # sedumi var order here: all soc -> same as q-only problem
    A = np.zeros((3, 4))
    A[:, 1:] = np.eye(3)
    b = a
    c = np.zeros(4)
    c[0] = 1.0
    path = str(tmp_path / "toy.mat")
    scipy.io.savemat(path, {"A": A, "b": b, "c": c,
                            "K": {"q": np.array([4.0])}})
    A2, b2, c2, cones, perm = load_sedumi_mat(path)
    assert cones == ConeSpec(soc=(4,))
    sol = solve_sedumi(path, eps=1e-5)
    assert sol.status_name.startswith("Solved")
    assert sol.pobj == pytest.approx(np.linalg.norm(a), abs=1e-3)


def test_conic_infeasible_detected():
    # x >= 0 with x = -1: primal infeasible
    A = np.array([[1.0]])
    b = np.array([-1.0])
    c = np.array([1.0])
    sol = abip.solve_qcp(A, b, c, ConeSpec.lp(1), eps=1e-5)
    assert "Infeasible" in sol.status_name


def test_conic_unbounded_detected():
    # min -x1, x1 - x2 = 0, x >= 0 (conic path)
    A = np.array([[1.0, -1.0]])
    b = np.array([0.0])
    c = np.array([-1.0, 0.0])
    sol = abip.solve_qcp(A, b, c, ConeSpec.lp(2), eps=1e-5)
    assert "Unbounded" in sol.status_name


def test_sedumi_device_suite_route(tmp_path):
    """`run_suite --sedumi --device --threads` end-to-end: .mat instances
    route through solve_qcp_device (whole-solve-per-program) and match
    the stored pobj_star oracle.

    Runs the real CLI in a SUBPROCESS: in-process, compiling the device
    program late in a long pytest run segfaults jaxlib's
    backend_compile_and_load (reproducible at the tail of the full
    suite, passes in any smaller subset -- an accumulated-process-state
    jaxlib bug, not a code path we control)."""
    import glob
    import json
    import os
    import shutil
    import subprocess
    import sys

    src = sorted(glob.glob(os.path.join(
        os.path.dirname(__file__), "..", "benchmarks", "suites",
        "conic_mini", "nnlsq*.mat")))[:2]
    assert src, "conic_mini suite files missing"
    suite_dir = tmp_path / "suite"
    suite_dir.mkdir()
    for p in src:
        shutil.copy(p, suite_dir)
    out_dir = tmp_path / "out"
    repo = os.path.join(os.path.dirname(__file__), "..")
    proc = subprocess.run(
        [sys.executable, "-m", "benchmarks.run_suite",
         "--sedumi", str(suite_dir), "--device", "--cpu", "--threads", "2",
         "--eps", "1e-6", "--outdir", str(out_dir)],
        cwd=repo, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    recs = [json.loads(ln) for ln in proc.stdout.splitlines()
            if ln.startswith("{")]
    assert len(recs) == 2
    for r in recs:
        assert r["status"] == "Solved", r
        assert r["obj_err"] <= 5e-6, r
