"""Barrier-ladder phase 1 in one loop (`ops/conic_sprint.fused_dr_ladder`).

Correctness bar: the ladder must reproduce the per-stage sprint
engine's phase-1 trajectories (same `adjust_barrier` tables,
`source/abip.c:994-1071`, evaluated in-loop on the f32 error-ratio) and
hand the same states to the delta endgame.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from abip import ConeSpec


def _family(n_inst, seed0):
    from benchmarks.conic_mini import randcone

    cones = ConeSpec(soc=(5,), rsoc=(4,), nonneg=10)
    As, bs, cs, stars = [], [], [], []
    for i in range(n_inst):
        _, A, b, c, _, star = randcone("x", 7, cones, seed=seed0 + i)
        As.append(A), bs.append(b), cs.append(c), stars.append(star)
    return (jnp.asarray(np.stack(As)), jnp.asarray(np.stack(bs)),
            jnp.asarray(np.stack(cs)), np.asarray(stars), cones)


def test_adjust_barrier_f32_matches_device_tables():
    """The unrolled where-chain tables must agree with the jnp
    searchsorted implementation across every bucket boundary."""
    from abip.conic_ops import adjust_barrier_device
    from abip.ops.conic_sprint import _adjust_barrier_f32

    eps, psi = 1e-6, 1.0
    mus = [1.0, 0.3, 1e-2, 1e-3, 3e-5, 9e-7, 1e-8]
    ratios = [0.5, 1.5, 1.9, 3.0, 5.0, 8.0, 12.0, 21.9, 22.0, 1e3, 1e8]
    for mu in mus:
        for r in ratios:
            m64, t64 = adjust_barrier_device(
                jnp.float64(mu), jnp.float64(r), eps, psi)
            m32, t32 = _adjust_barrier_f32(
                jnp.float32(mu), jnp.float32(r), jnp.float32(eps), psi)
            assert np.isclose(float(m32), float(m64), rtol=1e-6), (mu, r)
            assert np.isclose(float(t32), float(t64), rtol=1e-6), (mu, r)


def test_conic_ladder_phase1_matches_sprint():
    """sprint2 with phase1='ladder' vs phase1='sprint': same statuses,
    near-identical trajectories, oracle objectives."""
    from abip.parallel.batched_qcp import solve_qcp_batch

    As, bs, cs, stars, cones = _family(4, 300)
    kw = dict(cones=cones, eps=1e-6, precision="mixed", rho_y=1e-3,
              normalize=True, inner_crit_period=64, probe_period=8)
    r_s = solve_qcp_batch(As, bs, cs, engine="sprint2",
                          phase1="sprint", **kw)
    r_l = solve_qcp_batch(As, bs, cs, engine="sprint2",
                          phase1="ladder", **kw)
    assert (np.asarray(r_l.status) == 1).all()
    np.testing.assert_allclose(np.asarray(r_l.admm_iters),
                               np.asarray(r_s.admm_iters), rtol=0.10)
    assert np.abs(np.asarray(r_l.pobj) - stars).max() < 2e-5


def test_conic_ladder_certificates():
    """Infeasible (-2) and unbounded (-1) instances survive the ladder
    phase 1 and are certified by the endgame (`has_converged`,
    `source/abip.c:750-777`)."""
    from abip.parallel.batched_qcp import solve_qcp_batch

    # lane 0: x >= 0 with x = -1 (primal infeasible);
    # lane 1: min -x1, x1 - x2 = 0 (unbounded)
    As = jnp.asarray(np.stack([[[1.0, 0.0]], [[1.0, -1.0]]]))
    bs = jnp.asarray(np.stack([[-1.0], [0.0]]))
    cs = jnp.asarray(np.stack([[1.0, 0.0], [-1.0, 0.0]]))
    r = solve_qcp_batch(As, bs, cs, cones=ConeSpec.lp(2), eps=1e-5,
                        engine="sprint2", phase1="ladder",
                        precision="mixed", rho_y=1e-3, normalize=True,
                        inner_crit_period=64, probe_period=8)
    st = np.asarray(r.status)
    assert st[0] == -2, st
    assert st[1] == -1, st


def test_conic_ladder_cold_delta_rejected():
    """engine='delta' from a cold start must raise (the conic delta
    chunk lacks the k=0 tau_t := 1 case, `source/abip.c:186-254`)."""
    from abip.parallel.batched_qcp import solve_qcp_batch

    As, bs, cs, _, cones = _family(2, 900)
    with pytest.raises((ValueError, jax.errors.JaxRuntimeError),
                       match="endgame"):
        solve_qcp_batch(As, bs, cs, cones=cones, eps=1e-4,
                        engine="delta", cadence="chunk")


def test_stage_budget_floor_small_crit_period():
    """Regression: with inner_crit_period=1 the stage-stall budget must
    NOT shrink into the normal operating range (8*T=8 mis-stalled every
    fuzz class at ~100 iterations with mu crashed to the floor and a
    spurious status-2 exit)."""
    from abip.parallel.batched_qcp import solve_qcp_batch

    As, bs, cs, stars, cones = _family(3, 5_000)
    r = solve_qcp_batch(As, bs, cs, cones=cones, eps=1e-6,
                        engine="sprint2", phase1="ladder",
                        precision="mixed", rho_y=1e-3, normalize=True,
                        inner_crit_period=1, probe_period=1)
    assert (np.asarray(r.status) == 1).all(), np.asarray(r.status)
    assert np.abs(np.asarray(r.pobj) - stars).max() < 2e-5


def test_prepared_setup_matches_in_driver_normalize():
    """prepare_conic_batch + normalize=False must reproduce the
    in-driver normalize=True trajectories exactly (same equilibration,
    factors, and pre_calculate chain -- one code path, two call sites)."""
    from abip.parallel.batched_qcp import (_solve_qcp_batch_jit,
                                               prepare_conic_batch)

    As, bs, cs, stars, cones = _family(3, 7_100)
    kw = dict(cones=cones, eps=1e-6, precision="mixed", rho_y=1e-3,
              solver="inverse", cadence="chunk", inner_crit_period=64,
              probe_period=8)
    r_norm = _solve_qcp_batch_jit(As, bs, cs, None, engine="steps",
                                  normalize=True, **kw)
    prep = prepare_conic_batch(As, bs, cs, cones=cones, rho_y=1e-3,
                               precision="mixed", normalize=True)
    r_prep = _solve_qcp_batch_jit(As, bs, cs, None, engine="steps",
                                  normalize=False, prepared=prep, **kw)
    np.testing.assert_array_equal(np.asarray(r_prep.status),
                                  np.asarray(r_norm.status))
    np.testing.assert_array_equal(np.asarray(r_prep.admm_iters),
                                  np.asarray(r_norm.admm_iters))
    np.testing.assert_allclose(np.asarray(r_prep.pobj),
                               np.asarray(r_norm.pobj), rtol=1e-10)
