"""Checkpoint/resume roundtrip: interrupted solve continues to the optimum."""
import pytest
from scipy.optimize import linprog

import abip
from abip.lp import LPWorkspace
from abip.utils.checkpoint import SolverCheckpoint
from tests.conftest import random_lp


def test_checkpoint_resume_roundtrip(rng, tmp_path):
    A, b, c = random_lp(rng, 12, 40)
    ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, None), method="highs").fun
    ck = str(tmp_path / "state")

    # phase 1: run only a few outer iterations, checkpointing each
    s = abip.Settings(eps=1e-6, max_ipm_iters=4, adaptive=False)
    w1 = LPWorkspace(A, b, c, s)
    partial = w1.solve(checkpoint_path=ck, checkpoint_every=1)
    assert partial.status == abip.Status.UNFINISHED or \
        partial.status_name.startswith("Solved")

    # phase 2: resume from disk with full budget
    state = SolverCheckpoint.load(ck)
    assert state.ipm_iters >= 1
    w2 = LPWorkspace(A, b, c, abip.Settings(eps=1e-6, adaptive=False))
    done = w2.solve(resume=state)
    assert done.status_name.startswith("Solved")
    assert done.pobj == pytest.approx(ref, abs=1e-4 * (1 + abs(ref)))
    # resumed run should do less remaining work than a cold solve
    cold = LPWorkspace(A, b, c, abip.Settings(eps=1e-6, adaptive=False)).solve()
    assert done.admm_iters <= cold.admm_iters + state.admm_iters + 50
