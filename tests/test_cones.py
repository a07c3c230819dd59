"""Property tests of the cone barrier proxes.

The prox of the log-barrier satisfies closed-form KKT conditions; we verify
them directly (SURVEY.md section 4: "property tests of cone proxes (prox
optimality conditions)").  For x = prox_{lam*F}(t) with F the standard
log-barrier of the cone:

  nonneg: x^2 - t*x - lam = 0,  x > 0
  soc:    (x0 - t0) = 2*lam*x0/D,  (xb - tb) = -2*lam*xb/D,
          D = x0^2 - ||xb||^2 > 0
  rsoc:   (x1 - t1) = 2*lam*x2/D, (x2 - t2) = 2*lam*x1/D,
          (xb - tb) = -2*lam*xb/D,  D = 2*x1*x2 - ||xb||^2 > 0
"""
import numpy as np
import pytest

import jax.numpy as jnp

from abip.cones import ConeSpec, ConeLayout, cone_barrier_prox


def prox(spec, t, lam):
    layout = ConeLayout(spec)
    lam_e = jnp.full((spec.dim,), lam)
    return np.asarray(cone_barrier_prox(jnp.asarray(t), lam_e, layout))


@pytest.mark.parametrize("lam", [1e-2, 1.0, 10.0])
def test_nonneg_prox_kkt(rng, lam):
    t = rng.standard_normal(50) * 5
    x = prox(ConeSpec(nonneg=50), t, lam)
    assert (x > 0).all()
    np.testing.assert_allclose(x * x - t * x - lam, 0, atol=1e-9 * (1 + lam))


@pytest.mark.parametrize("lam", [1e-3, 0.5, 5.0])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_soc_prox_kkt(lam, seed):
    rng = np.random.default_rng(seed)
    dims = [2, 3, 7, 20]
    t = rng.standard_normal(sum(dims)) * 3
    x = prox(ConeSpec(soc=tuple(dims)), t, lam)
    pos = 0
    for q in dims:
        xb, tb = x[pos : pos + q], t[pos : pos + q]
        D = xb[0] ** 2 - np.sum(xb[1:] ** 2)
        assert D > 0, f"prox left the cone interior: D={D}"
        np.testing.assert_allclose(
            xb[0] - tb[0], 2 * lam * xb[0] / D, rtol=1e-6, atol=1e-8
        )
        np.testing.assert_allclose(
            xb[1:] - tb[1:], -2 * lam * xb[1:] / D, rtol=1e-6, atol=1e-8
        )
        pos += q


@pytest.mark.parametrize("lam", [1e-3, 0.5, 5.0])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rsoc_prox_kkt(lam, seed):
    rng = np.random.default_rng(seed)
    dims = [3, 5, 11]
    t = rng.standard_normal(sum(dims)) * 3
    x = prox(ConeSpec(rsoc=tuple(dims)), t, lam)
    pos = 0
    for q in dims:
        xb, tb = x[pos : pos + q], t[pos : pos + q]
        D = 2 * xb[0] * xb[1] - np.sum(xb[2:] ** 2)
        assert D > 0, f"prox left the cone interior: D={D}"
        np.testing.assert_allclose(
            xb[0] - tb[0], 2 * lam * xb[1] / D, rtol=1e-5, atol=1e-7
        )
        np.testing.assert_allclose(
            xb[1] - tb[1], 2 * lam * xb[0] / D, rtol=1e-5, atol=1e-7
        )
        np.testing.assert_allclose(
            xb[2:] - tb[2:], -2 * lam * xb[2:] / D, rtol=1e-5, atol=1e-7
        )
        pos += q


def test_mixed_cone_layout(rng):
    spec = ConeSpec(soc=(3, 1, 4), rsoc=(3,), free=2, zero=2, nonneg=5)
    n = spec.dim
    assert n == 3 + 1 + 4 + 3 + 2 + 2 + 5
    t = rng.standard_normal(n)
    x = prox(spec, t, 0.7)
    # free passes through, zero clamps
    assert np.allclose(x[11:13], t[11:13])  # free
    assert np.allclose(x[13:15], 0.0)       # zero
    assert (x[15:] > 0).all()               # nonneg
    # 1-d soc behaves as nonneg (`source/abip.c:364-367`)
    assert x[3] > 0


def test_cold_start_strictly_interior():
    spec = ConeSpec(soc=(3, 5), rsoc=(4,), free=2, zero=1, nonneg=6)
    from abip.cones import cone_membership_violation

    layout = ConeLayout(spec)
    x0 = layout.interior_point(jnp.float64)
    assert float(cone_membership_violation(x0, layout)) <= 0


@pytest.mark.parametrize("lam", [1e-9, 1e-6, 1e3, 1e6])
def test_prox_extreme_lambda_fuzz(lam):
    """Domain safety at extreme barrier weights: outputs stay finite and
    strictly interior for every cone class."""
    rng = np.random.default_rng(99)
    spec = ConeSpec(soc=(2, 5), rsoc=(3, 6), free=3, zero=2, nonneg=6)
    from abip.cones import cone_membership_violation

    layout = ConeLayout(spec)
    for scale in (1e-6, 1.0, 1e6):
        t = rng.standard_normal(spec.dim) * scale
        x = np.asarray(cone_barrier_prox(jnp.asarray(t),
                                         jnp.full((spec.dim,), lam), layout))
        assert np.isfinite(x).all(), (lam, scale)
        # strictly interior (up to roundoff) where the barrier applies
        viol = float(cone_membership_violation(jnp.asarray(x), layout))
        assert viol <= 1e-6 * max(1.0, np.abs(x).max()), (lam, scale, viol)
