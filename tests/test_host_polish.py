"""f64 polish of an f32-floored batched conic solve.

The anchored-f32 engines floor the primal residual at roughly
sqrt(q)*eps32 for wide embeddings; `parallel.batched_qcp.host_polish`
finishes the last barrier stage in the f64 host-loop driver from the
batch lane's (x, y, s, mu) state.  Here the batch side is the
same batched driver stopped early by k_cap: the polish must take the
partial state to a fully certified Solved and the same optimum as an
uninterrupted solve.
"""
import numpy as np
import pytest

from abip import ConeSpec
from abip.parallel.batched_qcp import host_polish, solve_qcp_batch
from abip.qcp import solve_qcp


def _tiny_lasso_embed(m=6, n=10, seed=3):
    """Dense RSOC embedding of a tiny LASSO instance
    (`lasso_config.c:8-93` reformulation, built explicitly)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((m, n)) / np.sqrt(m)
    w0 = np.zeros(n)
    w0[: max(1, n // 5)] = rng.standard_normal(max(1, n // 5))
    y = X @ w0 + 0.01 * rng.standard_normal(m)
    lam = 0.1 * np.abs(X.T @ y).max()
    p, q = m + 1, 2 + m + 2 * n
    A = np.zeros((p, q))
    A[0, 0] = 1.0
    A[1:, 2 : 2 + m] = np.eye(m)
    A[1:, 2 + m : 2 + m + n] = X
    A[1:, 2 + m + n :] = -X
    b = np.concatenate([[1.0], y])
    c = np.zeros(q)
    c[1] = 1.0
    c[2 + m :] = lam
    return A, b, c, ConeSpec(rsoc=(2 + m,), nonneg=2 * n)


def test_host_polish_finishes_a_capped_solve():
    A, b, c, cones = _tiny_lasso_embed()
    eps = 1e-6
    kw = dict(cones=cones, eps=eps, rho_y=1e-3, normalize=True)

    full = solve_qcp(A, b, c, cones, eps=eps)
    assert full.status_name == "Solved"

    # "accelerator" pass: stop well short of convergence
    res = solve_qcp_batch(A[None], b[None], c[None], None,
                          engine="steps", k_cap=np.int32(40), **kw)
    assert int(res.status[0]) != 1          # genuinely unfinished
    assert res.mu is not None and res.tol_inner is not None

    sol = host_polish(A, b, c, cones, res, lane=0, eps=eps)
    assert sol.status_name == "Solved"
    assert sol.res_pri < eps and sol.res_dual < eps and sol.rel_gap < eps
    assert sol.pobj == pytest.approx(full.pobj, rel=1e-4, abs=1e-6)


def test_host_polish_respects_settings_overrides():
    A, b, c, cones = _tiny_lasso_embed(seed=11)
    res = solve_qcp_batch(A[None], b[None], c[None], None,
                          engine="steps", k_cap=np.int32(30),
                          cones=cones, eps=1e-6, rho_y=1e-3,
                          normalize=True)
    sol = host_polish(A, b, c, cones, res, lane=0, eps=1e-4,
                      max_ipm_iters=200)
    assert sol.status_name == "Solved"
    assert sol.res_pri < 1e-4
