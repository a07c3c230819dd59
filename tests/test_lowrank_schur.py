"""Low-rank custom KKT backend (`linsys.schur.LowRankWoodburySolver`):
the SVM operators' exact diag+rank-(n+1) Gram (`svm_config.c:577-637`
custom-KKT role)."""
import jax.numpy as jnp
import numpy as np

from abip.problem import LinearOperator


def test_lowrank_woodbury_matches_dense_solve():
    """G^-1 via SMW must match the dense Woodbury solve to f64 roundoff
    on a random exact diag+low-rank decomposition."""
    from abip.linsys.schur import DenseSchurSolver, LowRankWoodburySolver

    rng = np.random.default_rng(11)
    m, k = 40, 5
    U = rng.standard_normal((m, k))
    g = rng.random(m) + 0.5
    rho_y = np.full(m, 1e-3)
    # build a dense A whose Gram A Hinv A' equals diag(g) + U U':
    # A = [U, diag(sqrt(g))], H = I
    n = k + m
    A = np.concatenate([U, np.diag(np.sqrt(g))], axis=1)
    rho_x = np.ones(n)
    H_inv = jnp.ones(n) * 0.5          # H = rho_x + Q_diag = 2
    Qd = np.ones(n)                    # Q_diag = 1 -> H = 2
    # scale A so A Hinv A' = (diag(g) + U U')/2; feed the solver the
    # matching U/g halves
    dense = DenseSchurSolver(jnp.asarray(A), jnp.asarray(Qd),
                             jnp.asarray(rho_y), jnp.asarray(rho_x),
                             mode="chol", form="woodbury")
    op = LinearOperator(m, n, lambda x: jnp.asarray(A) @ x,
                        lambda y_: jnp.asarray(A).T @ y_, nnz=m * n)
    lr = LowRankWoodburySolver(op, H_inv, jnp.asarray(rho_y),
                               jnp.asarray(U) * np.sqrt(0.5),
                               jnp.ones(k), jnp.asarray(g) * 0.5)
    w_y = rng.standard_normal(m)
    w_x = rng.standard_normal(n)
    zy1, zx1, _ = dense.solve(jnp.asarray(w_y), jnp.asarray(w_x))
    zy2, zx2, _ = lr.solve(jnp.asarray(w_y), jnp.asarray(w_x))
    np.testing.assert_allclose(np.asarray(zy2), np.asarray(zy1),
                               rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(np.asarray(zx2), np.asarray(zx1),
                               rtol=1e-9, atol=1e-10)


def test_svm_operator_factories_match_cg():
    """Both SVM operator forms through the custom KKT agree with the
    dense-embedding oracle objective."""
    from benchmarks.generate import svm_instance

    from abip.problems import solve_svm

    X, y = svm_instance(m=120, n=12, seed=9)
    for form in ("qp", "socp"):
        wd, bd, od, sd = solve_svm(X, y, 1.0, form=form, eps=1e-4)
        wl, bl, ol, sl = solve_svm(X, y, 1.0, form=form, eps=1e-4,
                                   matrix_free=True)
        assert sl.status_name.startswith("Solved"), form
        assert abs(od - ol) / max(1.0, abs(od)) < 1e-3, (form, od, ol)
