"""Euclidean cone projection properties.

Oracles: cone membership, idempotence, the Moreau decomposition
z = Pi_K(z) - Pi_K*(-z), best-approximation optimality vs sampled cone
points, and Jacobian consistency with the implicit-diff layer
(`diff.dprojection_dense`)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from abip.cones import (ConeLayout, ConeSpec, cone_membership_violation,
                            cone_project)

SPECS = [
    ConeSpec(nonneg=12),
    ConeSpec(soc=(5,), nonneg=4),
    ConeSpec(soc=(4, 3, 1), rsoc=(5, 3), free=2, zero=3, nonneg=6),
    ConeSpec(rsoc=(7,), free=1),
    ConeSpec(soc=(2, 2), zero=2),
]


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    jax.config.update("jax_platforms", "cpu")


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_membership_and_idempotence(spec, seed):
    rng = np.random.default_rng(seed)
    layout = ConeLayout(spec)
    z = jnp.asarray(3.0 * rng.standard_normal(spec.dim))
    p = cone_project(z, layout)
    assert float(cone_membership_violation(p, layout)) <= 1e-9
    np.testing.assert_allclose(np.asarray(cone_project(p, layout)),
                               np.asarray(p), atol=1e-12)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("seed", [3, 4])
def test_moreau_decomposition(spec, seed):
    """z = Pi_K(z) - Pi_K*(-z), and the two parts are orthogonal."""
    rng = np.random.default_rng(seed)
    layout = ConeLayout(spec)
    z = jnp.asarray(2.0 * rng.standard_normal(spec.dim))
    p = np.asarray(cone_project(z, layout))
    q = np.asarray(cone_project(-z, layout, dual=True))
    np.testing.assert_allclose(p - q, np.asarray(z), atol=1e-10)
    assert abs(float(p @ q)) <= 1e-10


@pytest.mark.parametrize("spec", SPECS)
def test_best_approximation(spec):
    """||z - Pi(z)|| <= ||z - y|| for sampled y in K (projection is the
    nearest point)."""
    rng = np.random.default_rng(7)
    layout = ConeLayout(spec)
    z = jnp.asarray(2.0 * rng.standard_normal(spec.dim))
    p = np.asarray(cone_project(z, layout))
    dz = np.linalg.norm(np.asarray(z) - p)
    for s in range(20):
        y = np.asarray(cone_project(
            jnp.asarray(3.0 * rng.standard_normal(spec.dim)), layout))
        assert dz <= np.linalg.norm(np.asarray(z) - y) + 1e-9


def test_jacobian_matches_diff_layer():
    """jacfwd(cone_project) equals the hand-derived projection Jacobian
    used by the implicit-differentiation layer, at a generic point."""
    from abip.diff import dprojection_dense

    spec = ConeSpec(soc=(4,), rsoc=(4,), free=1, nonneg=3)
    layout = ConeLayout(spec)
    rng = np.random.default_rng(11)
    z = jnp.asarray(rng.standard_normal(spec.dim))
    J = jax.jacfwd(lambda v: cone_project(v, layout))(z)
    P = dprojection_dense(z, layout)
    np.testing.assert_allclose(np.asarray(J), np.asarray(P), atol=1e-9)


def test_soc_analytic_branches():
    layout = ConeLayout(ConeSpec(soc=(3,)))
    inside = jnp.asarray([2.0, 1.0, 0.5])
    np.testing.assert_allclose(np.asarray(cone_project(inside, layout)),
                               np.asarray(inside))
    polar = jnp.asarray([-3.0, 1.0, 0.5])   # ||u|| <= -t: projects to 0
    np.testing.assert_allclose(np.asarray(cone_project(polar, layout)),
                               np.zeros(3))
    edge = jnp.asarray([0.0, 3.0, 4.0])     # alpha = 5/2, u/||u||=(.6,.8)
    np.testing.assert_allclose(np.asarray(cone_project(edge, layout)),
                               [2.5, 1.5, 2.0], atol=1e-12)


@pytest.mark.parametrize("spec", SPECS)
def test_barrier_prox_limits_to_projection(spec):
    """As lambda -> 0+ the barrier prox converges to the Euclidean
    projection (the interior-regularized map degenerates to its
    projection); ties the solver's prox to the PDHG/diff primitive."""
    from abip.cones import cone_barrier_prox

    rng = np.random.default_rng(3)
    layout = ConeLayout(spec)
    z = jnp.asarray(2.0 * rng.standard_normal(spec.dim))
    p = np.asarray(cone_project(z, layout))
    prev_err = None
    for lam in (1e-4, 1e-6, 1e-8):
        lam_e = jnp.full(spec.dim, lam)
        q = np.asarray(cone_barrier_prox(z, lam_e, layout))
        # the barrier prox has no zero-cone clamp issue: zero coords
        # match the projection exactly; compare the rest in norm
        err = np.linalg.norm(q - p) / (1 + np.linalg.norm(p))
        if prev_err is not None:
            assert err <= prev_err * 1.01 + 1e-12
        prev_err = err
    assert prev_err < 1e-3
