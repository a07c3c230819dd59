"""Direct unit tests for the conic dense Schur solver's form dispatch.

The Woodbury dual form must produce the SAME solution as the primal
factorization (it solves the identical system S z_x = rhs through the
m x m G = R_y + A H^-1 A'); `form="auto"` picks it by the 4m <= 3n flop
crossover.  Reference analogue: the per-shape KKT dispatch of
`src/abip-qcp/source/lasso_config.c:507-565`.
"""
import numpy as np
import pytest

from abip.linsys.schur import DenseSchurSolver


def _mk(m, n, q_diag=False, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    ry = np.full(m, 1e-3)
    rx = np.full(n, 1.0)
    Q = np.abs(rng.standard_normal(n)) if q_diag else None
    return A, Q, ry, rx


def _solve_dense_oracle(A, Q, ry, rx, w_y, w_x):
    """Numpy oracle: S z_x = w_x + A'(w_y/ry); z_y = (w_y - A z_x)/ry."""
    m, n = A.shape
    S = (A / ry[:, None]).T @ A + np.diag(rx)
    if Q is not None:
        S = S + np.diag(Q)
    rhs = w_x + A.T @ (w_y / ry)
    z_x = np.linalg.solve(S, rhs)
    z_y = (w_y - A @ z_x) / ry
    return z_y, z_x


@pytest.mark.parametrize("q_diag", [False, True])
def test_forms_agree_with_oracle(q_diag, rng):
    m, n = 17, 60
    A, Q, ry, rx = _mk(m, n, q_diag)
    w_y = rng.standard_normal(m)
    w_x = rng.standard_normal(n)
    zy_ref, zx_ref = _solve_dense_oracle(A, Q, ry, rx, w_y, w_x)
    for form in ("primal", "woodbury", "auto"):
        s = DenseSchurSolver(A, Q, ry, rx, form=form)
        z_y, z_x, _ = s.solve(w_y, w_x)
        np.testing.assert_allclose(np.asarray(z_x), zx_ref, rtol=1e-9,
                                   atol=1e-9, err_msg=form)
        np.testing.assert_allclose(np.asarray(z_y), zy_ref, rtol=1e-8,
                                   atol=1e-8, err_msg=form)
    # auto picks woodbury here (4m=68 <= 3n=180)
    assert DenseSchurSolver(A, Q, ry, rx).form == "woodbury"


def test_auto_threshold_and_guards(rng):
    # near-square: auto stays primal (4m > 3n)
    A, Q, ry, rx = _mk(30, 35)
    assert DenseSchurSolver(A, Q, ry, rx).form == "primal"
    # explicit woodbury works even at m >= n (G is m x m SPD regardless)
    A2, _, ry2, rx2 = _mk(20, 15, seed=3)
    w_y = rng.standard_normal(20)
    w_x = rng.standard_normal(15)
    zy_ref, zx_ref = _solve_dense_oracle(A2, None, ry2, rx2, w_y, w_x)
    s = DenseSchurSolver(A2, None, ry2, rx2, form="woodbury")
    z_y, z_x, _ = s.solve(w_y, w_x)
    np.testing.assert_allclose(np.asarray(z_x), zx_ref, rtol=1e-9, atol=1e-9)
    # dense (non-diagonal) Q cannot take the dual form
    Qd = np.eye(15)
    with pytest.raises(ValueError):
        DenseSchurSolver(A2, Qd, ry2, rx2, form="woodbury")
    with pytest.raises(ValueError):
        DenseSchurSolver(A2, None, ry2, rx2, mode="inverse_mixed",
                         form="woodbury")
