"""Differentiable solution maps (`abip/diff.py`).

Golden oracles: the envelope theorem (analytic dual = gradient), central
finite differences of the full solve, and a closed-form equality-QP
Jacobian.  All checks run at nondegenerate, strictly complementary
solutions where the solution map is differentiable.
"""
import jax
import jax.numpy as jnp
import numpy as np

from abip.cones import ConeSpec
from abip.diff import (solve_lasso_grad, solve_lp_grad, solve_qcp_grad,
                           solve_svm_grad)

KW = dict(eps=1e-9, max_ipm=200, max_admm=200_000)


def _lp_instance(m=8, n=20, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    x0 = rng.random(n) + 0.5
    y0 = rng.standard_normal(m)
    s0 = rng.random(n) + 0.5
    return (jnp.asarray(A), jnp.asarray(A @ x0),
            jnp.asarray(A.T @ y0 + s0))


def test_lp_grad_b_is_dual():
    """Envelope theorem: d(c'x*)/db = y* (`diff.py` module doc)."""
    A, b, c = _lp_instance()
    x, y, s = solve_lp_grad(A, b, c, **KW)
    gb = jax.grad(lambda bb: c @ solve_lp_grad(A, bb, c, **KW)[0])(b)
    np.testing.assert_allclose(np.asarray(gb), np.asarray(y),
                               rtol=1e-5, atol=1e-6)


def test_lp_grad_A_envelope():
    """d(c'x*)/dA = -y x' at a nondegenerate vertex."""
    A, b, c = _lp_instance(seed=3)
    x, y, s = solve_lp_grad(A, b, c, **KW)
    gA = jax.grad(lambda AA: c @ solve_lp_grad(AA, b, c, **KW)[0])(A)
    np.testing.assert_allclose(np.asarray(gA),
                               -np.outer(np.asarray(y), np.asarray(x)),
                               rtol=1e-4, atol=1e-6)


def test_lp_grad_c_vertex_constant():
    """x* is locally constant in c at a nondegenerate vertex: the
    solution-map part of d(v'x*)/dc is zero."""
    A, b, c = _lp_instance(seed=5)
    v = jnp.asarray(np.random.default_rng(9).standard_normal(c.shape[0]))
    gc = jax.grad(lambda cc: v @ solve_lp_grad(A, b, cc, **KW)[0])(c)
    np.testing.assert_allclose(np.asarray(gc), 0.0, atol=1e-6)


def test_lp_grad_b_finite_difference():
    """Central FD of the full solve vs the implicit gradient."""
    A, b, c = _lp_instance(seed=7)
    v = jnp.asarray(np.random.default_rng(11).standard_normal(c.shape[0]))

    def loss(bb):
        return v @ solve_lp_grad(A, bb, c, **KW)[0]

    g = jax.grad(loss)(b)
    rng = np.random.default_rng(13)
    db = jnp.asarray(rng.standard_normal(b.shape[0]))
    h = 1e-4
    fd = (loss(b + h * db) - loss(b - h * db)) / (2 * h)
    np.testing.assert_allclose(float(g @ db), float(fd), rtol=2e-2)


def test_lp_grad_jit_and_vmap():
    """The layer composes with jit and vmap (batched instances)."""
    A, b, c = _lp_instance(seed=21)
    v = jnp.ones_like(c)

    gfn = jax.jit(jax.grad(lambda bb: v @ solve_lp_grad(A, bb, c, **KW)[0]))
    g1 = gfn(b)
    assert np.all(np.isfinite(np.asarray(g1)))

    bs = jnp.stack([b, b * 1.01])
    gs = jax.vmap(gfn)(bs)
    assert gs.shape == bs.shape
    np.testing.assert_allclose(np.asarray(gs[0]), np.asarray(g1),
                               rtol=1e-8)


def test_lp_grad_unsolved_is_nan():
    """Gradients of non-Solved instances are NaN-poisoned on purpose."""
    A = jnp.asarray([[1.0, 1.0], [1.0, 1.0]])
    b = jnp.asarray([1.0, 3.0])   # infeasible
    c = jnp.asarray([1.0, 1.0])
    g = jax.grad(lambda bb: jnp.sum(solve_lp_grad(A, bb, c, eps=1e-6)[0]))(b)
    assert np.all(np.isnan(np.asarray(g)))


def _socp_instance(seed=0):
    """Random strictly feasible SOCP: K = SOC(4) x nonneg(3)."""
    rng = np.random.default_rng(seed)
    cones = ConeSpec(soc=(4,), nonneg=3)
    n, m = cones.dim, 3
    A = rng.standard_normal((m, n))
    u = rng.standard_normal(3)
    x0 = np.concatenate([[np.linalg.norm(u) + 1.0], u, rng.random(3) + 0.5])
    ud = rng.standard_normal(3) * 0.3
    s0 = np.concatenate([[np.linalg.norm(ud) + 0.7], ud, rng.random(3) + 0.5])
    y0 = rng.standard_normal(m)
    return (jnp.asarray(A), jnp.asarray(A @ x0),
            jnp.asarray(A.T @ y0 + s0), cones)


def test_socp_grad_finite_difference():
    A, b, c, cones = _socp_instance(seed=2)
    kw = dict(eps=1e-8, max_ipm=300, max_admm=300_000)
    v = jnp.asarray(np.random.default_rng(5).standard_normal(c.shape[0]))

    def loss(bb):
        return v @ solve_qcp_grad(A, bb, c, cones=cones, **kw)[0]

    g = jax.grad(loss)(b)
    rng = np.random.default_rng(8)
    db = jnp.asarray(rng.standard_normal(b.shape[0]))
    h = 1e-4
    fd = (loss(b + h * db) - loss(b - h * db)) / (2 * h)
    np.testing.assert_allclose(float(g @ db), float(fd), rtol=3e-2)


def test_socp_grad_b_is_dual():
    A, b, c, cones = _socp_instance(seed=4)
    kw = dict(eps=1e-8, max_ipm=300, max_admm=300_000)
    x, y, s = solve_qcp_grad(A, b, c, cones=cones, **kw)
    gb = jax.grad(
        lambda bb: c @ solve_qcp_grad(A, bb, c, cones=cones, **kw)[0])(b)
    np.testing.assert_allclose(np.asarray(gb), np.asarray(y),
                               rtol=1e-4, atol=1e-5)


def test_qp_grad_matches_closed_form():
    """Diagonal-Q QP with the nonneg solution strictly interior on the
    support: compare against the closed-form equality-QP solution map
    restricted to the active set."""
    rng = np.random.default_rng(6)
    m, n = 3, 7
    A = rng.standard_normal((m, n))
    x0 = rng.random(n) + 0.5          # strictly positive target
    b = A @ x0
    q = rng.random(n) + 0.5           # Q = diag(q), strictly convex
    # choose c so the UNCONSTRAINED-sign KKT solution is x0 > 0:
    # Q x0 + c - A'y0 = 0 with s = 0 on the (full) support
    y0 = rng.standard_normal(m)
    c = A.T @ y0 - q * x0
    cones = ConeSpec(nonneg=n)
    kw = dict(eps=1e-8, max_ipm=300, max_admm=300_000)

    Aj, bj, cj, qj = map(jnp.asarray, (A, b, c, q))
    x, y, s = solve_qcp_grad(Aj, bj, cj, cones=cones, Q_diag=qj, **kw)
    assert float(jnp.min(x)) > 1e-3   # interior: closed form applies

    def closed_form(bb):
        # [[Q, -A'], [A, 0]] [x; y] = [-c; b]
        K = jnp.block([[jnp.diag(qj), -Aj.T],
                       [Aj, jnp.zeros((m, m))]])
        sol = jnp.linalg.solve(K, jnp.concatenate([-cj, bb]))
        return sol[:n]

    v = jnp.asarray(rng.standard_normal(n))
    g_impl = jax.grad(
        lambda bb: v @ solve_qcp_grad(Aj, bb, cj, cones=cones, Q_diag=qj,
                                      **kw)[0])(bj)
    g_ref = jax.grad(lambda bb: v @ closed_form(bb))(bj)
    np.testing.assert_allclose(np.asarray(g_impl), np.asarray(g_ref),
                               rtol=1e-4, atol=1e-6)


def test_lasso_grad_lambda_analytic():
    """dw_S/dlam = -(X_S'X_S)^-1 sign(w_S) on a stable support (the
    classical LASSO sensitivity; zero off the support)."""
    rng = np.random.default_rng(12)
    m, n = 12, 6
    X = rng.standard_normal((m, n))
    w_true = np.array([1.5, -2.0, 0.0, 0.0, 1.0, 0.0])
    y = X @ w_true + 0.05 * rng.standard_normal(m)
    lam = 0.5
    kw = dict(eps=1e-8, max_ipm=300, max_admm=300_000)

    w = np.asarray(solve_lasso_grad(X, y, lam, **kw))
    S = np.abs(w) > 1e-4
    assert S.sum() >= 2          # nontrivial support
    XS = X[:, S]
    dws = -np.linalg.solve(XS.T @ XS, np.sign(w[S]))

    v = rng.standard_normal(n)
    g = jax.grad(
        lambda l: jnp.asarray(v) @ solve_lasso_grad(X, y, l, **kw))(
            jnp.asarray(lam))
    np.testing.assert_allclose(float(g), float(v[S] @ dws),
                               rtol=1e-3, atol=1e-6)


def test_svm_grad_C_finite_difference():
    """FD check of d(w, b0)/dC on a separable-ish random instance."""
    rng = np.random.default_rng(3)
    m, n = 16, 3
    X = rng.standard_normal((m, n)) + 0.8 * np.where(
        np.arange(m)[:, None] < m // 2, 1.0, -1.0)
    y = np.where(np.arange(m) < m // 2, 1.0, -1.0)
    kw = dict(eps=1e-8, max_ipm=300, max_admm=300_000)
    v = rng.standard_normal(n)

    def loss(C):
        w, b0 = solve_svm_grad(X, y, C, **kw)
        return jnp.asarray(v) @ w + 0.3 * b0

    C0 = jnp.asarray(0.7)
    g = jax.grad(loss)(C0)
    h = 1e-4
    fd = (loss(C0 + h) - loss(C0 - h)) / (2 * h)
    np.testing.assert_allclose(float(g), float(fd), rtol=3e-2, atol=1e-6)


def test_lp_grad_degenerate_is_finite():
    """Duplicate columns make the solution set non-unique; the lstsq
    (minimum-norm) adjoint still returns a finite heuristic gradient
    (the diffcp LSQR behavior)."""
    rng = np.random.default_rng(17)
    m, n = 6, 12
    A = rng.standard_normal((m, n))
    A[:, -1] = A[:, 0]               # duplicate column
    x0 = rng.random(n) + 0.5
    b = A @ x0
    c = A.T @ rng.standard_normal(m) + rng.random(n) + 0.5
    c[-1] = c[0]                     # identical cost: degenerate optimum
    Aj, bj, cj = map(jnp.asarray, (A, b, c))
    g = jax.grad(
        lambda bb: jnp.sum(solve_lp_grad(Aj, bb, cj, **KW)[0]))(bj)
    assert np.all(np.isfinite(np.asarray(g)))
