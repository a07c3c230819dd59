"""Anchored-delta conic endgame (`ops/conic_delta.py`).

Correctness bar: reproduce the anchored-f64 steps engine's conic
trajectories at chunk granularity.  Reference math: DR projection +
tau quadratic `source/abip.c:186-314`, cone proxes `cones.c:130-289`,
inner criterion `qcp_config.c:518-557`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from abip import ConeSpec
from abip.cones import ConeLayout
from abip.ops.conic_sprint import cone_kernel_data


def test_cone_prox_delta_scales_with_delta():
    """P(dt) error must be PROPORTIONAL to |dt| (no absolute floor) for
    every cone type -- the property that makes the f32 delta endgame
    f64-grade."""
    import abip.cones as C
    from abip.ops.conic_delta import _cone_prox_delta

    rng = np.random.default_rng(0)
    spec = ConeSpec(soc=(25, 25), rsoc=(10,), nonneg=40)
    layout = ConeLayout(spec)
    n = spec.dim
    cd = cone_kernel_data(layout)
    lam = jnp.float32(1e-5)
    t0 = jnp.asarray(rng.standard_normal((1, n)).astype(np.float32))
    with jax.default_matmul_precision("highest"):
        for scale, bound in ((1e-4, 1e-7), (1e-6, 1e-9), (1e-8, 1e-11)):
            dt = jnp.asarray((scale * rng.standard_normal((1, n)))
                             .astype(np.float32))
            t64 = jnp.asarray(np.asarray(t0)[0], jnp.float64)
            d64 = jnp.asarray(np.asarray(dt)[0], jnp.float64)
            p_true = (C.cone_barrier_prox(t64 + d64,
                                          jnp.full((n,), 1e-5), layout)
                      - C.cone_barrier_prox(t64, jnp.full((n,), 1e-5),
                                            layout))
            p_est = _cone_prox_delta(dt, t0, lam, cd)
            err = np.abs(np.asarray(p_est)[0]
                         - np.asarray(p_true)).max()
            assert err < bound, (scale, err)


@pytest.mark.parametrize("endgame", ["delta"])
def test_conic_sprint2_delta_endgame_matches_steps(endgame):
    """sprint2 + delta endgame: same statuses/counts as steps, oracle
    objectives."""
    from benchmarks.conic_mini import randcone

    from abip.parallel.batched_qcp import solve_qcp_batch

    cones = ConeSpec(soc=(5,), nonneg=10)
    As, bs, cs, stars = [], [], [], []
    for i in range(4):
        _, A, b, c, _, star = randcone("x", 8, cones, seed=100 + i)
        As.append(A), bs.append(b), cs.append(c), stars.append(star)
    As, bs, cs = map(lambda z: jnp.asarray(np.stack(z)), (As, bs, cs))
    kw = dict(cones=cones, eps=1e-6, precision="mixed", rho_y=1e-3,
              normalize=True, inner_crit_period=64, probe_period=8)
    r_s = solve_qcp_batch(As, bs, cs, engine="sprint2",
                          endgame="steps", **kw)
    r_d = solve_qcp_batch(As, bs, cs, engine="sprint2",
                          endgame=endgame, **kw)
    assert (np.asarray(r_d.status) == 1).all()
    np.testing.assert_allclose(np.asarray(r_d.admm_iters),
                               np.asarray(r_s.admm_iters), rtol=0.10)
    assert np.abs(np.asarray(r_d.pobj) - np.asarray(stars)).max() < 2e-5
