"""Capped resume rounds (traced k_cap).

Long solves can run as capped rounds resumed from returned state
(checkpointing, straggler compaction); these tests pin the semantics.
"""
import jax.numpy as jnp
import numpy as np

from abip import ConeSpec


def test_conic_kcap_resume_matches_uncapped():
    from benchmarks.conic_mini import randcone

    from abip.parallel.batched_qcp import solve_qcp_batch

    cones = ConeSpec(soc=(5,), nonneg=10)
    _, A, b, c, _, star = randcone("x", 8, cones, seed=102)
    As = jnp.asarray(A)[None]
    bs = jnp.asarray(b)[None]
    cs = jnp.asarray(c)[None]
    kw = dict(cones=cones, eps=1e-6, precision="mixed", rho_y=1e-3,
              normalize=True, solver="inverse", cadence="chunk",
              inner_crit_period=64, probe_period=8, max_admm=100_000)
    r_full = solve_qcp_batch(As, bs, cs, **kw)
    assert int(r_full.status[0]) == 1

    # capped rounds: 60-iteration rungs on a SHARED scalar cap
    st, k, rounds = None, 0, 0
    while True:
        r = solve_qcp_batch(As, bs, cs, init_state=st,
                            k_cap=np.int32(k + 60), **kw)
        rounds += 1
        k = int(r.admm_iters[0])
        if int(r.status[0]) != 0 or rounds > 50:
            break
        st = (r.u_raw, r.v_raw, r.mu, r.tol_inner, r.admm_iters,
              r.ipm_iters, r.status)
    assert int(r.status[0]) == 1
    assert rounds > 1, "cap never engaged"
    # same fixed point; iteration counts may differ slightly at the
    # cap-boundary check points
    assert abs(float(r.pobj[0]) - star) < 2e-5
    assert abs(k - int(r_full.admm_iters[0])) <= 0.2 * int(
        r_full.admm_iters[0]) + 128
