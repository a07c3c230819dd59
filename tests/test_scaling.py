"""Equilibration property tests (SURVEY.md section 7 'hard parts':
"Equilibration + un-scaling correctness ... property-test roundtrips early").
"""
import numpy as np
import scipy.sparse as sp

import jax.numpy as jnp

from abip.cones import ConeSpec, ConeLayout
from abip.scaling import equilibrate, equilibrate_conic, equilibrate_sparse
from abip.settings import Settings


def test_equilibrate_reconstructs(rng):
    """A_scaled = diag(1/D) A diag(1/E) * scale exactly."""
    A = rng.standard_normal((20, 35)) * np.exp(rng.standard_normal((20, 35)))
    stgs = Settings(scale=2.0)
    A_s, scal = equilibrate(jnp.asarray(A), stgs)
    D = np.asarray(scal.D)
    E = np.asarray(scal.E)
    recon = (A / D[:, None] / E[None, :]) * 2.0
    np.testing.assert_allclose(np.asarray(A_s), recon, rtol=1e-12)


def test_equilibrate_improves_conditioning(rng):
    # badly row/col-scaled matrix: ruiz should pull inf-norms toward 1
    A = rng.standard_normal((15, 25))
    A *= np.exp(3 * rng.standard_normal(15))[:, None]
    A *= np.exp(3 * rng.standard_normal(25))[None, :]
    A_s, _ = equilibrate(jnp.asarray(A), Settings())
    row_inf = np.abs(np.asarray(A_s)).max(axis=1)
    col_inf = np.abs(np.asarray(A_s)).max(axis=0)
    assert row_inf.max() / row_inf.min() < 10
    assert col_inf.max() / col_inf.min() < 10
    before = np.abs(A).max() / np.abs(A).min()
    after = np.abs(np.asarray(A_s)).max() / np.abs(np.asarray(A_s))[np.asarray(A_s) != 0].min()
    assert after < before


def test_sparse_equilibrate_matches_dense(rng):
    A = rng.standard_normal((12, 30)) * (rng.random((12, 30)) < 0.3)
    A[np.arange(12), rng.integers(0, 30, 12)] += 1.0
    stgs = Settings()
    Ad, scal_d = equilibrate(jnp.asarray(A), stgs)
    Asp, scal_s = equilibrate_sparse(sp.csr_matrix(A), stgs)
    # the dense pipeline accumulates its scaling factors in f32 (they
    # are equilibration heuristics; see the equilibrate docstring), the
    # host sparse pipeline in f64 -- agreement is f32-grade
    np.testing.assert_allclose(np.asarray(scal_d.D), np.asarray(scal_s.D),
                               rtol=3e-5)
    np.testing.assert_allclose(np.asarray(scal_d.E), np.asarray(scal_s.E),
                               rtol=3e-5)
    np.testing.assert_allclose(Asp.toarray(), np.asarray(Ad), rtol=3e-5,
                               atol=1e-7)


def test_conic_equilibrate_preserves_cone_blocks(rng):
    # SOC block columns must share one scaling factor (mean tying)
    spec = ConeSpec(soc=(4, 3), nonneg=5)
    layout = ConeLayout(spec)
    n = spec.dim
    A = rng.standard_normal((8, n)) * np.exp(2 * rng.standard_normal((8, n)))
    b = rng.standard_normal(8)
    c = rng.standard_normal(n)
    stgs = Settings(origin_rescale=True)
    A_s, Q_s, b_s, c_s, scal = equilibrate_conic(
        jnp.asarray(A), None, jnp.asarray(b), jnp.asarray(c), layout, stgs)
    E = np.asarray(scal.E)
    # within each SOC block, E is constant
    assert np.allclose(E[0:4], E[0]), E[0:4]
    assert np.allclose(E[4:7], E[4]), E[4:7]
    # reconstruction: A_s = D^-1 A E^-1
    recon = A / np.asarray(scal.D)[:, None] / E[None, :]
    np.testing.assert_allclose(np.asarray(A_s), recon, rtol=1e-10)


def test_equilibrate_conic_diag_matches_full():
    """A 1-D diagonal Q must equilibrate EXACTLY like the same Q as a
    full matrix (the diagonal path skipping Q in E was a measured
    trajectory-parity bug vs the reference C solver)."""
    import numpy as np

    from abip.cones import ConeLayout, ConeSpec
    from abip.qcp import conic_defaults
    from abip.scaling import equilibrate_conic

    rng = np.random.default_rng(4)
    cones = ConeSpec(soc=(4,), nonneg=8)
    n = cones.dim
    m = 5
    A = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    c = rng.standard_normal(n)
    q = rng.random(n) * 10.0 + 0.01
    layout = ConeLayout(cones)
    stgs = conic_defaults()

    Ad, qd, bd, cd, sd = equilibrate_conic(
        jnp.asarray(A), jnp.asarray(q), jnp.asarray(b), jnp.asarray(c),
        layout, stgs)
    Af, Qf, bf, cf, sf = equilibrate_conic(
        jnp.asarray(A), jnp.asarray(np.diag(q)), jnp.asarray(b),
        jnp.asarray(c), layout, stgs)
    np.testing.assert_allclose(np.asarray(Ad), np.asarray(Af), atol=1e-14)
    np.testing.assert_allclose(np.asarray(qd), np.diag(np.asarray(Qf)),
                               atol=1e-14)
    np.testing.assert_allclose(np.asarray(sd.E), np.asarray(sf.E),
                               atol=1e-14)
    np.testing.assert_allclose(np.asarray(bd), np.asarray(bf), atol=1e-14)
