"""Bench-record certificate validation: Solved is unclaimable without
finite pobj/dobj/residuals.

The reference always reports a finite dual objective alongside the
primal in its result struct (`/root/reference/src/abip-qcp/include/
abip.h:139-158`); round 4 shipped a device LASSO record whose "Solved"
status carried dobj=NaN through a broken extract path.  The bench
layer now downgrades any such record to 'Unverified' before it is
written (`benchmarks/ml_sweep._validate_solved`, applied by both the
ML sweeps and `benchmarks/run_suite`).
"""
import math

from benchmarks.ml_sweep import _validate_solved


def _rec(**over):
    rec = {"name": "x", "status": "Solved", "pobj": 1.0, "dobj": 1.0,
           "pres": 1e-7, "dres": 1e-7, "gap": 1e-8, "time": 0.5}
    rec.update(over)
    return rec


def test_finite_solved_record_passes_unchanged():
    rec = _validate_solved(_rec())
    assert rec["status"] == "Solved"
    assert "unverified_fields" not in rec


def test_nan_dobj_downgrades_to_unverified():
    rec = _validate_solved(_rec(dobj=float("nan")))
    assert rec["status"] == "Unverified"
    assert rec["unverified_fields"] == ["dobj"]


def test_inf_residual_downgrades_and_names_every_bad_field():
    rec = _validate_solved(_rec(pres=float("inf"), gap=float("nan")))
    assert rec["status"] == "Unverified"
    assert set(rec["unverified_fields"]) == {"pres", "gap"}


def test_non_solved_statuses_are_left_alone():
    for status in ("status2", "MaxIters", "Infeasible", "Unbounded"):
        rec = _validate_solved(_rec(status=status, dobj=float("nan")))
        assert rec["status"] == status


def test_missing_fields_do_not_block_solved():
    # run_suite LP records carry no dobj key at all; absence is not NaN
    rec = _rec()
    del rec["dobj"]
    rec = _validate_solved(rec)
    assert rec["status"] == "Solved"
    assert math.isfinite(rec["pobj"])
