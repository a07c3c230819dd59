"""Application-operator tests: LASSO and SVM vs independent references.

LASSO is checked against its subgradient optimality conditions and a
proximal-gradient (ISTA) reference; SVM forms are checked against each
other and against scipy.optimize on the (smooth-ified) primal.
"""
import numpy as np
import pytest

from abip.problems import solve_lasso, solve_svm


def ista_lasso(X, y, lam, iters=20000):
    """Proximal-gradient reference solution."""
    L = np.linalg.norm(X, 2) ** 2
    w = np.zeros(X.shape[1])
    for _ in range(iters):
        g = X.T @ (X @ w - y)
        w = w - g / L
        w = np.sign(w) * np.maximum(np.abs(w) - lam / L, 0)
    return w


@pytest.mark.parametrize("m,n,lam", [(30, 12, 0.5), (15, 40, 1.0)])
def test_lasso_matches_ista(rng, m, n, lam):
    X = rng.standard_normal((m, n))
    w_true = np.zeros(n)
    w_true[: max(2, n // 5)] = rng.standard_normal(max(2, n // 5))
    y = X @ w_true + 0.1 * rng.standard_normal(m)

    w, obj, sol = solve_lasso(X, y, lam, eps=1e-6)
    assert sol.status_name in ("Solved", "Solved/Inaccurate")

    w_ref = ista_lasso(X, y, lam)
    obj_ref = 0.5 * np.sum((X @ w_ref - y) ** 2) + lam * np.abs(w_ref).sum()
    assert obj == pytest.approx(obj_ref, abs=1e-3 * (1 + obj_ref))

    # subgradient optimality: |X'(Xw - y)| <= lam (+ tol), equality on support
    grad = X.T @ (X @ w - y)
    assert np.all(np.abs(grad) <= lam + 1e-2 * (1 + lam))


def test_lasso_zero_solution(rng):
    # lam >= ||X'y||_inf forces w = 0
    X = rng.standard_normal((20, 8))
    y = rng.standard_normal(20)
    lam = 1.1 * np.abs(X.T @ y).max()
    w, obj, sol = solve_lasso(X, y, lam, eps=1e-6)
    np.testing.assert_allclose(w, 0, atol=1e-3)
    assert obj == pytest.approx(0.5 * y @ y, abs=1e-2)


def test_svm_qp_socp_agree(rng):
    m, n = 40, 5
    X = rng.standard_normal((m, n))
    w_true = rng.standard_normal(n)
    y = np.sign(X @ w_true + 0.3 * rng.standard_normal(m))
    y[y == 0] = 1.0
    C = 1.0
    w1, b1, obj1, s1 = solve_svm(X, y, C, form="qp", eps=1e-5)
    w2, b2, obj2, s2 = solve_svm(X, y, C, form="socp", eps=1e-5)
    assert s1.status_name in ("Solved", "Solved/Inaccurate")
    assert s2.status_name in ("Solved", "Solved/Inaccurate")
    assert obj1 == pytest.approx(obj2, abs=1e-2 * (1 + obj1))


def test_svm_separable(rng):
    # well-separated data: hinge loss ~ 0, small ||w||
    m, n = 30, 3
    X = np.concatenate([rng.standard_normal((m // 2, n)) + 4,
                        rng.standard_normal((m // 2, n)) - 4])
    y = np.concatenate([np.ones(m // 2), -np.ones(m // 2)])
    w, b0, obj, sol = solve_svm(X, y, 10.0, form="qp", eps=1e-5)
    margins = y * (X @ w + b0)
    assert (margins > 0.9).all()          # all points classified with margin


def test_svm_bad_labels(rng):
    X = rng.standard_normal((10, 3))
    y = np.arange(10).astype(float)
    with pytest.raises(ValueError, match=r"\+/-1"):
        solve_svm(X, y, 1.0)


def test_lasso_matrix_free_matches_dense(rng):
    X = rng.standard_normal((25, 10))
    w0 = np.zeros(10)
    w0[:3] = [1.5, -1.0, 0.5]
    y = X @ w0 + 0.05 * rng.standard_normal(25)
    w1, obj1, s1 = solve_lasso(X, y, 0.5, eps=1e-5)
    w2, obj2, s2 = solve_lasso(X, y, 0.5, matrix_free=True, eps=1e-5)
    assert s2.status_name in ("Solved", "Solved/Inaccurate")
    assert obj2 == pytest.approx(obj1, abs=1e-3 * (1 + obj1))
    np.testing.assert_allclose(w2, w1, atol=1e-3)


def test_svm_matrix_free_matches_dense(rng):
    m, n = 30, 4
    X = rng.standard_normal((m, n))
    y = np.sign(X @ rng.standard_normal(n) + 0.2 * rng.standard_normal(m))
    y[y == 0] = 1.0
    w1, b1, o1, s1 = solve_svm(X, y, 1.0, form="qp", eps=1e-5)
    w2, b2, o2, s2 = solve_svm(X, y, 1.0, matrix_free=True, eps=1e-5)
    assert s2.status_name.startswith("Solved")
    assert o2 == pytest.approx(o1, abs=1e-2 * (1 + o1))


def test_svm_matrix_free_socp_matches_dense(rng):
    """`svm_operator_socp` (matrix-free SOCP, `svm_config.c:175-229`
    re-derivation) must agree with the dense SOCP embedding."""
    m, n = 30, 4
    X = rng.standard_normal((m, n))
    y = np.sign(X @ rng.standard_normal(n) + 0.2 * rng.standard_normal(m))
    y[y == 0] = 1.0
    w1, b1, o1, s1 = solve_svm(X, y, 1.0, form="socp", eps=1e-5)
    w2, b2, o2, s2 = solve_svm(X, y, 1.0, form="socp", matrix_free=True,
                               eps=1e-5)
    assert s2.status_name.startswith("Solved")
    assert o2 == pytest.approx(o1, abs=1e-2 * (1 + o1))
    np.testing.assert_allclose(w2, w1, atol=2e-2)


def test_svm_socp_operator_matches_dense_matrix(rng):
    """The scaled matrix-free operator must equal the explicitly scaled
    dense matrix (matvec/rmatvec adjoint consistency)."""
    import jax.numpy as jnp

    from abip.problems.svm import svm_operator_socp, svm_to_conic_socp

    m, n = 12, 3
    X = rng.standard_normal((m, n))
    y = np.sign(rng.standard_normal(m))
    y[y == 0] = 1.0
    prob = svm_operator_socp(X, y, 2.0, scaled=False)
    dense = svm_to_conic_socp(X, y, 2.0)
    q = dense.A.shape[1]
    Aop = np.stack([np.asarray(prob.A.matvec(jnp.eye(q)[:, j]))
                    for j in range(q)], axis=1)
    np.testing.assert_allclose(Aop, dense.A, atol=1e-12)
    # adjoint: <Az, u> == <z, A'u>
    z = rng.standard_normal(q)
    u = rng.standard_normal(m + 1)
    lhs = float(np.dot(np.asarray(prob.A.matvec(jnp.asarray(z))), u))
    rhs = float(np.dot(z, np.asarray(prob.A.rmatvec(jnp.asarray(u)))))
    assert lhs == pytest.approx(rhs, abs=1e-10)


def test_diagonal_q_matches_dense_q(rng):
    from abip import solve_qcp
    from abip.problems.svm import svm_to_conic_qp

    m, n = 20, 3
    X = rng.standard_normal((m, n))
    y = np.sign(X @ rng.standard_normal(n))
    y[y == 0] = 1.0
    prob = svm_to_conic_qp(X, y, 1.0)
    s_full = solve_qcp(prob.A, prob.b, prob.c, prob.cones, Q=prob.Q, eps=1e-5)
    s_diag = solve_qcp(prob.A, prob.b, prob.c, prob.cones,
                       Q=np.diag(prob.Q), eps=1e-5)
    assert s_diag.status_name.startswith("Solved")
    assert s_diag.pobj == pytest.approx(s_full.pobj, abs=1e-3 * (1 + abs(s_full.pobj)))
