"""CLI surface tests (`python -m abip`).

Run in subprocesses: the CLI owns backend selection, and (jaxlib
constraint) XLA compiles must not run late in this long pytest process.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.join(os.path.dirname(__file__), "..")


def run_cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "abip", *args, "--cpu"],
        capture_output=True, text=True, cwd=REPO, timeout=240)


def test_cli_mps_json(tmp_path):
    import scipy.sparse as sp

    from abip.io.mps import GeneralLP
    from abip.io.mps_write import write_mps

    rng = np.random.default_rng(2)
    A = np.abs(rng.standard_normal((3, 8))) + 0.1
    x0 = rng.random(8) + 0.5
    p = GeneralLP(c=rng.random(8) + 0.1, A=sp.csc_matrix(A),
                  row_lo=A @ x0, row_hi=A @ x0,
                  lb=np.zeros(8), ub=np.full(8, np.inf), name="t")
    path = tmp_path / "t.mps"
    write_mps(p, str(path))
    r = run_cli(str(path), "--json", "--eps", "1e-7")
    assert r.returncode == 0, r.stderr[-500:]
    rec = json.loads([ln for ln in r.stdout.splitlines()
                      if ln.startswith("{")][-1])
    assert rec["status"] == "Solved"
    from scipy.optimize import linprog

    ref = linprog(p.c, A_eq=A, b_eq=A @ x0, bounds=(0, None),
                  method="highs")
    assert abs(rec["pobj"] - ref.fun) < 1e-5 * (1 + abs(ref.fun))


def test_cli_cbf_objective_sense():
    """For a MAX-sense .cbf, `objective` is the instance-sense value
    (matching the optima.json oracle) while pobj/dobj stay internally
    consistent in solver sense."""
    path = os.path.join(REPO, "benchmarks", "suites", "cblib_mini",
                        "rand_soc_b_max.cbf")
    with open(os.path.join(REPO, "benchmarks", "suites", "cblib_mini",
                           "optima.json")) as f:
        star = json.load(f)["rand_soc_b_max"]
    r = run_cli(path, "--json", "--eps", "1e-6")
    assert r.returncode == 0, r.stderr[-500:]
    rec = json.loads([ln for ln in r.stdout.splitlines()
                      if ln.startswith("{")][-1])
    assert rec["status"] == "Solved"
    assert abs(rec["objective"] - star) < 1e-4 * (1 + abs(star))
    # solver sense: MAX instance embeds as MIN of the negated objective
    assert abs(rec["pobj"] - (-rec["objective"])) < 1e-9 * (1 + abs(star))
    assert abs(rec["pobj"] - rec["dobj"]) <= rec["rel_gap"] * (
        1 + abs(rec["pobj"]) + abs(rec["dobj"])) + 1e-12


def test_cli_nonexistent_file():
    r = run_cli("/nonexistent/file.mps", "--json")
    assert r.returncode != 0
