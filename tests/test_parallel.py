"""Tests for the batched (vmap) and sharded (shard_map) execution paths.

Runs on the 8-virtual-device CPU mesh set up by conftest (SURVEY.md
section 4's simulated-mesh strategy).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from scipy.optimize import linprog

import abip
from abip.parallel.batched import device_solve_lp, solve_lp_batch
from abip.parallel.sharded import make_sharded_kkt_solver
from tests.conftest import random_lp


def _batch(rng, B, m, n):
    As = np.zeros((B, m, n))
    bs = np.zeros((B, m))
    cs = np.zeros((B, n))
    refs = []
    for i in range(B):
        A, b, c = random_lp(rng, m, n)
        As[i], bs[i], cs[i] = A, b, c
        refs.append(linprog(c, A_eq=A, b_eq=b, bounds=(0, None), method="highs").fun)
    return As, bs, cs, np.array(refs)


def test_device_solve_matches_host(rng):
    A, b, c = random_lp(rng, 12, 40)
    ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, None), method="highs").fun
    res = device_solve_lp(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c), eps=1e-6)
    assert int(res.status) == 1
    assert float(res.pobj) == pytest.approx(ref, abs=1e-4 * (1 + abs(ref)))


def test_batch_vmap(rng):
    As, bs, cs, refs = _batch(rng, 4, 10, 30)
    res = solve_lp_batch(jnp.asarray(As), jnp.asarray(bs), jnp.asarray(cs), eps=1e-6)
    assert (np.asarray(res.status) == 1).all()
    np.testing.assert_allclose(np.asarray(res.pobj), refs,
                               atol=1e-3 * (1 + np.abs(refs).max()))


def test_batch_sharded_over_mesh(rng):
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    mesh = Mesh(np.array(jax.devices()), ("batch",))
    B = len(jax.devices())
    As, bs, cs, refs = _batch(rng, B, 10, 30)
    res = solve_lp_batch(jnp.asarray(As), jnp.asarray(bs), jnp.asarray(cs),
                         mesh=mesh, eps=1e-5)
    assert (np.asarray(res.status) == 1).all()
    np.testing.assert_allclose(np.asarray(res.pobj), refs,
                               atol=1e-2 * (1 + np.abs(refs).max()))


def test_sharded_kkt_solver_matches_dense(rng):
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    mesh = Mesh(np.array(jax.devices()), ("rows",))
    ndev = len(jax.devices())
    m, n = 8 * ndev, 200
    A = rng.standard_normal((m, n))
    rho_y = 1e-3
    solve = make_sharded_kkt_solver(jnp.asarray(A), rho_y, mesh,
                                    tol=1e-11, max_iters=1000)
    w_y = rng.standard_normal(m)
    w_x = rng.standard_normal(n)
    z_y, z_x, iters = solve(jnp.asarray(w_y), jnp.asarray(w_x))
    K = np.block([[rho_y * np.eye(m), A], [A.T, -np.eye(n)]])
    z = np.linalg.solve(K, np.concatenate([w_y, w_x]))
    np.testing.assert_allclose(np.asarray(z_y), z[:m], atol=1e-7)
    np.testing.assert_allclose(np.asarray(z_x), z[m:], atol=1e-7)


def test_sharded_rejects_bad_row_count(rng):
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    mesh = Mesh(np.array(jax.devices()), ("rows",))
    A = rng.standard_normal((len(jax.devices()) * 4 + 1, 20))
    with pytest.raises(ValueError, match="must divide"):
        make_sharded_kkt_solver(jnp.asarray(A), 1e-3, mesh)


def test_graft_entry_contract():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    ge.dryrun_multichip(min(8, len(jax.devices())))


def test_batched_qcp_soc_toys(rng):
    from abip import ConeSpec
    from abip.parallel.batched_qcp import solve_qcp_batch

    B, d = 4, 3
    As = np.zeros((B, d, d + 1))
    bs = np.zeros((B, d))
    cs = np.zeros((B, d + 1))
    refs = []
    for i in range(B):
        a = rng.standard_normal(d)
        As[i, :, 1:] = np.eye(d)
        bs[i] = a
        cs[i, 0] = 1.0
        refs.append(np.linalg.norm(a))
    res = solve_qcp_batch(jnp.asarray(As), jnp.asarray(bs), jnp.asarray(cs),
                          cones=ConeSpec(soc=(d + 1,)), eps=1e-5)
    assert (np.asarray(res.status) == 1).all()
    np.testing.assert_allclose(np.asarray(res.pobj), refs, atol=1e-3)


def test_qcp_device_single_and_forms(rng):
    """solve_qcp_device (B=1 whole-solve program) matches the known
    optimum, and the primal and Woodbury Schur forms agree (same
    system, factored n x n vs m x m)."""
    from abip import ConeSpec
    from abip.parallel.batched_qcp import solve_qcp_device
    from benchmarks.conic_mini import randcone

    cones = ConeSpec(soc=(8,), nonneg=22)
    name, A, b, c, cn, star = randcone("dev", 10, cones, 4_321)
    kw = dict(cones=cn, eps=1e-6, precision="mixed", normalize=True,
              rho_y=1e-3, max_admm=200_000, solver="inverse",
              inner_crit_period=8)
    results = {}
    for form in ("primal", "woodbury", "auto"):
        r = solve_qcp_device(jnp.asarray(A), jnp.asarray(b),
                             jnp.asarray(c), form=form, **kw)
        assert int(r.status) == 1, form
        np.testing.assert_allclose(float(r.pobj), star, atol=1e-4)
        results[form] = int(r.admm_iters)
    # the two factor forms solve the SAME system: trajectories agree to
    # roundoff-induced wobble (a few iterations at most)
    assert abs(results["primal"] - results["woodbury"]) <= 3

    with pytest.raises(ValueError):
        # m >= n rejects the explicit woodbury request
        solve_qcp_device(jnp.ones((5, 3)), jnp.ones((5,)),
                         jnp.ones((3,)), cones=ConeSpec(nonneg=3),
                         form="woodbury")


def test_lasso_sweep_batch(rng):
    from abip.problems.lasso import solve_lasso_batch, solve_lasso

    B, m, n = 3, 20, 8
    Xs = rng.standard_normal((B, m, n))
    ys = rng.standard_normal((B, m))
    lams = np.array([0.5, 1.0, 2.0])
    W, objs, res = solve_lasso_batch(Xs, ys, lams, eps=1e-5)
    assert (np.asarray(res.status) == 1).all()
    for i in range(B):
        _, obj_ref, _ = solve_lasso(Xs[i], ys[i], float(lams[i]), eps=1e-5)
        assert objs[i] == pytest.approx(obj_ref, abs=1e-2 * (1 + obj_ref))


def test_mixed_inverse_solver_matches_cholesky(rng):
    from abip.parallel.batched import device_solve_lp
    from tests.conftest import random_lp

    A, b, c = random_lp(rng, 10, 30)
    r1 = device_solve_lp(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c),
                         eps=1e-6, precision="mixed", solver="cholesky")
    r2 = device_solve_lp(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c),
                         eps=1e-6, precision="mixed", solver="inverse")
    assert int(r1.status) == int(r2.status) == 1
    assert int(r1.admm_iters) == int(r2.admm_iters)
    assert abs(float(r1.pobj) - float(r2.pobj)) < 1e-8


def test_qres_period_solves_to_tolerance(rng):
    """Thinned inner-criterion cadence (the bench's qres_period=8 config):
    trajectories may differ from the every-iteration reference cadence,
    but the solution contract (eps, scipy oracle) must hold."""
    from scipy.optimize import linprog

    from abip.parallel.batched import device_solve_lp
    from tests.conftest import random_lp

    A, b, c = random_lp(rng, 12, 40)
    r = device_solve_lp(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c),
                        eps=1e-6, precision="mixed", solver="inverse",
                        qres_period=8)
    assert int(r.status) == 1
    assert float(r.rel_gap) < 1e-6
    ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, None), method="highs")
    assert abs(float(r.pobj) - ref.fun) / max(1.0, abs(ref.fun)) < 1e-5


@pytest.mark.parametrize("precision,engine", [("f64", "steps"),
                                              ("mixed", "steps"),
                                              ("mixed", "sprint")])
def test_chunk_cadence_matches_oracle(rng, precision, engine):
    """cadence='chunk' (the structural, vmap-safe cadence that keeps
    the f64 check off every vmapped iteration): single-instance solves to the
    scipy oracle in every engine/precision combination."""
    from scipy.optimize import linprog

    from abip.parallel.batched import device_solve_lp
    from tests.conftest import random_lp

    A, b, c = random_lp(rng, 12, 40)
    ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, None), method="highs").fun
    r = device_solve_lp(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c),
                        eps=1e-6, precision=precision, engine=engine,
                        solver="inverse" if precision == "mixed" else "cholesky",
                        qres_period=8, cadence="chunk")
    assert int(r.status) == 1
    assert float(r.rel_gap) < 1e-6
    assert float(r.pobj) == pytest.approx(ref, abs=1e-4 * (1 + abs(ref)))


def test_chunk_cadence_batch_default_and_validation(rng):
    """solve_lp_batch defaults to cadence='chunk'; bad values raise."""
    from abip.parallel.batched import device_solve_lp, solve_lp_batch

    with pytest.raises(ValueError, match="cadence"):
        device_solve_lp(jnp.eye(2), jnp.ones(2), jnp.ones(2),
                        cadence="bogus")

    As, bs, cs, refs = _batch(rng, 3, 10, 30)
    r = solve_lp_batch(jnp.asarray(As), jnp.asarray(bs), jnp.asarray(cs),
                       eps=1e-6, precision="mixed", solver="inverse",
                       qres_period=16, avg_period=20)
    assert (np.asarray(r.status) == 1).all()
    np.testing.assert_allclose(np.asarray(r.pobj), refs,
                               atol=1e-3 * (1 + np.abs(refs).max()))


def test_stream_driver_matches_oracle(rng):
    """Segmented streaming driver: every instance solved to the scipy
    oracle; lane swap exercised by N > B; a parked lane (N not a
    multiple of B) stays frozen."""
    from abip.parallel.segmented import solve_lp_stream

    probs, refs = [], []
    for _ in range(5):
        A, b, c = random_lp(rng, 10, 30)
        probs.append((A, b, c))
        refs.append(linprog(c, A_eq=A, b_eq=b, bounds=(0, None),
                            method="highs").fun)
    res, info = solve_lp_stream(probs, B=2, seg_chunks=8, qres_period=16,
                                eps=1e-6)
    assert info["solved"] == 5
    for r, ref in zip(res, refs):
        assert r["status"] == 1
        assert r["pobj"] == pytest.approx(ref, abs=1e-4 * (1 + abs(ref)))
    with pytest.raises(ValueError, match="same-shape"):
        A2, b2, c2 = random_lp(rng, 11, 30)
        solve_lp_stream([probs[0], (A2, b2, c2)])


def test_heterogeneous_padded_suite(rng):
    from abip.parallel.batched import solve_lp_suite

    shapes = [(8, 25), (12, 40), (10, 33)]
    probs, refs = [], []
    for m, n in shapes:
        A, b, c = random_lp(rng, m, n)
        probs.append((A, b, c))
        refs.append(linprog(c, A_eq=A, b_eq=b, bounds=(0, None),
                            method="highs").fun)
    out = solve_lp_suite(probs, eps=1e-6)
    for r, ref, (m, n) in zip(out, refs, shapes):
        assert r["status"] == 1
        assert r["pobj"] == pytest.approx(ref, abs=1e-4 * (1 + abs(ref)))
        assert r["x"].shape == (n,)
        assert r["y"].shape == (m,)


def test_batched_qcp_mixed_matches_f64(rng):
    from abip import ConeSpec
    from abip.parallel.batched_qcp import solve_qcp_batch

    B, d = 3, 4
    As = np.zeros((B, d, d + 1))
    bs = np.zeros((B, d))
    cs = np.zeros((B, d + 1))
    for i in range(B):
        As[i, :, 1:] = np.eye(d)
        bs[i] = rng.standard_normal(d)
        cs[i, 0] = 1.0
    r1 = solve_qcp_batch(jnp.asarray(As), jnp.asarray(bs), jnp.asarray(cs),
                         cones=ConeSpec(soc=(d + 1,)), eps=1e-5,
                         precision="f64")
    r2 = solve_qcp_batch(jnp.asarray(As), jnp.asarray(bs), jnp.asarray(cs),
                         cones=ConeSpec(soc=(d + 1,)), eps=1e-5,
                         precision="mixed")
    np.testing.assert_array_equal(np.asarray(r1.status), np.asarray(r2.status))
    np.testing.assert_array_equal(np.asarray(r1.admm_iters),
                                  np.asarray(r2.admm_iters))
    np.testing.assert_allclose(np.asarray(r1.pobj), np.asarray(r2.pobj),
                               atol=1e-7)


def test_workspace_shard_over_mesh(rng):
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    from abip.lp import LPWorkspace
    import abip

    ndev = len(jax.devices())
    m, n = 8 * ndev, 200
    A, b, c = random_lp(rng, m, n)
    ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, None), method="highs").fun
    mesh = Mesh(np.array(jax.devices()), ("rows",))
    w = LPWorkspace(A, b, c, abip.Settings(eps=1e-5, adaptive=False))
    w.shard(mesh)
    sol = w.solve()
    assert sol.status_name.startswith("Solved")
    assert sol.pobj == pytest.approx(ref, abs=1e-3 * (1 + abs(ref)))
    with pytest.raises(ValueError, match="divisible"):
        LPWorkspace(A[: 8 * ndev - 1], b[: 8 * ndev - 1], c,
                    abip.Settings(eps=1e-4)).shard(mesh)


def test_sharded_full_solve_matches_unsharded_cg(rng):
    """The FULL ADMM loop iterates distributed (VERDICT round 1 #4): a
    sharded solve must track the unsharded CG solve's trajectory."""
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    from abip.lp import LPWorkspace
    import abip

    ndev = len(jax.devices())
    m, n = 8 * ndev, 160
    A, b, c = random_lp(rng, m, n)
    ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, None), method="highs").fun
    s = abip.Settings(eps=1e-6, adaptive=False, linsys="cg")
    base = LPWorkspace(A, b, c, s).solve()
    mesh = Mesh(np.array(jax.devices()), ("rows",))
    sh = LPWorkspace(A, b, c, s).shard(mesh, linsys="cg").solve()
    assert sh.status_name.startswith("Solved")
    assert sh.pobj == pytest.approx(ref, abs=1e-4 * (1 + abs(ref)))
    # same math, same schedule: iteration counts agree up to CG reduction
    # reordering noise
    assert abs(sh.admm_iters - base.admm_iters) <= max(
        5, 0.05 * base.admm_iters)


def test_sharded_dense_replicates_factor(rng):
    """linsys='dense' sharding keeps the Cholesky factor replicated and
    reproduces the unsharded dense trajectory EXACTLY."""
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    from abip.lp import LPWorkspace
    import abip

    ndev = len(jax.devices())
    m, n = 8 * ndev, 160
    A, b, c = random_lp(rng, m, n)
    s = abip.Settings(eps=1e-6, adaptive=False)
    base = LPWorkspace(A, b, c, s).solve()
    mesh = Mesh(np.array(jax.devices()), ("rows",))
    w = LPWorkspace(A, b, c, s)
    w.shard(mesh, linsys="dense")
    assert w.ops.chol is not None
    sh = w.solve()
    assert sh.status_name.startswith("Solved")
    assert sh.admm_iters == base.admm_iters
    assert sh.pobj == pytest.approx(base.pobj, rel=1e-9)


def test_qcp_inner_crit_period(rng):
    """Thinned conic inner-criterion cadence: statuses and objectives
    match the every-iteration cadence at the solve tolerance."""
    from abip import ConeSpec
    from abip.parallel.batched_qcp import solve_qcp_batch

    B, m, n = 3, 8, 15
    cones = ConeSpec(soc=(5,), nonneg=10)
    As, bs, cs = [], [], []
    for _ in range(B):
        A = rng.standard_normal((m, n))
        x0 = np.concatenate([[2.0], rng.standard_normal(4) * 0.3,
                             rng.random(10) + 0.5])
        As.append(A), bs.append(A @ x0), cs.append(rng.random(n) + 0.1)
    As, bs, cs = map(lambda z: jnp.asarray(np.stack(z)), (As, bs, cs))

    r1 = solve_qcp_batch(As, bs, cs, cones=cones, eps=1e-6)
    r4 = solve_qcp_batch(As, bs, cs, cones=cones, eps=1e-6,
                         inner_crit_period=4)
    assert (np.asarray(r1.status) == np.asarray(r4.status)).all()
    solved = np.asarray(r1.status) == 1
    assert solved.any()
    np.testing.assert_allclose(np.asarray(r4.pobj)[solved],
                               np.asarray(r1.pobj)[solved],
                               rtol=1e-5, atol=1e-5)


def test_qcp_inverse_solver_equivalent():
    """Conic explicit-inverse Schur apply: same statuses, oracle-accurate
    objectives (trajectories may differ from trisolves in f32, unlike the
    LP driver where they are bit-identical)."""
    from abip import ConeSpec
    from abip.parallel.batched_qcp import solve_qcp_batch
    from benchmarks.conic_mini import randcone

    cones = ConeSpec(soc=(5,), nonneg=10)
    As, bs, cs, stars = [], [], [], []
    for i in (2, 3):                       # well-conditioned seeds
        _, A, b, c, _, star = randcone("x", 8, cones, seed=100 + i)
        As.append(A), bs.append(b), cs.append(c), stars.append(star)
    As, bs, cs = map(lambda z: jnp.asarray(np.stack(z)), (As, bs, cs))

    r1 = solve_qcp_batch(As, bs, cs, cones=cones, eps=1e-6,
                         precision="mixed")
    r2 = solve_qcp_batch(As, bs, cs, cones=cones, eps=1e-6,
                         precision="mixed", solver="inverse")
    assert (np.asarray(r1.status) == 1).all()
    assert (np.asarray(r2.status) == 1).all()
    np.testing.assert_allclose(np.asarray(r2.pobj), stars, atol=1e-5)
    np.testing.assert_allclose(np.asarray(r1.pobj), stars, atol=1e-5)


def test_qcp_mixed_anchor_reanchoring_robustness():
    """Regression: per-stage-only anchors let the f32 delta products
    drift to NaN on long stages (an equilibration-sensitive SOC batch
    previously ran >100k iterations and blew up).  With periodic
    re-anchoring every lane solves to the exact oracle, with and without
    built-in equilibration."""
    from abip import ConeSpec
    from abip.parallel.batched_qcp import solve_qcp_batch
    from benchmarks.conic_mini import randcone

    cones = ConeSpec(soc=(5,), nonneg=10)
    As, bs, cs, stars = [], [], [], []
    for i in range(4):
        _, A, b, c, _, star = randcone("x", 8, cones, seed=100 + i)
        As.append(A), bs.append(b), cs.append(c), stars.append(star)
    As, bs, cs = map(lambda z: jnp.asarray(np.stack(z)), (As, bs, cs))

    for normalize in (False, True):
        r = solve_qcp_batch(As, bs, cs, cones=cones, eps=1e-6,
                            precision="mixed", normalize=normalize)
        assert (np.asarray(r.status) == 1).all(), normalize
        assert (np.asarray(r.admm_iters) < 5000).all(), normalize
        np.testing.assert_allclose(np.asarray(r.pobj), stars, atol=2e-5)


def test_cadence_knob_validation():
    """Cadence knobs < 1 must raise, not hang: anchor_period=0 in mixed
    mode makes the jitted outer loop non-terminating (review round 2)."""
    A = jnp.eye(2)
    b = jnp.ones(2)
    c = jnp.ones(2)
    for kw in (dict(anchor_period=0, precision="mixed"),
               dict(avg_period=0), dict(qres_period=0)):
        with pytest.raises(ValueError, match=">= 1"):
            device_solve_lp(A, b, c, **kw)

    from abip.cones import ConeSpec
    from abip.parallel.batched_qcp import solve_qcp_batch

    As = jnp.ones((1, 2, 3))
    bs = jnp.ones((1, 2))
    cs = jnp.ones((1, 3))
    for kw in (dict(anchor_period=0, precision="mixed"),
               dict(inner_crit_period=0)):
        with pytest.raises(ValueError, match=">= 1"):
            solve_qcp_batch(As, bs, cs, cones=ConeSpec(nonneg=3), **kw)


def test_lp_mixed_anchor_cap_and_avg_period(rng):
    """A small anchor_period forces repeated cap-exit re-anchoring and a
    thinned avg_period cadence (the bench configuration's knobs); the
    solution must still match the scipy oracle."""
    A, b, c = random_lp(rng, 12, 40)
    ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, None), method="highs").fun
    res = device_solve_lp(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c),
                          eps=1e-6, precision="mixed", solver="inverse",
                          qres_period=16, avg_period=20, anchor_period=40)
    assert int(res.status) == 1
    assert float(res.pobj) == pytest.approx(ref, abs=1e-4 * (1 + abs(ref)))


def test_host_pool_matches_oracle(rng):
    """Thread-pool suite driver: results identical to serial solves and
    correct vs scipy (shared jit cache; XLA releases the GIL)."""
    from abip.parallel.host_pool import solve_lp_pool

    probs, refs = [], []
    for _ in range(4):
        A, b, c = random_lp(rng, 10, 30)
        probs.append((A, b, c))
        refs.append(linprog(c, A_eq=A, b_eq=b, bounds=(0, None),
                            method="highs").fun)
    out = solve_lp_pool(probs, workers=4, eps=1e-6, precision="mixed",
                        solver="inverse")
    assert all(int(r.status) == 1 for r in out)
    np.testing.assert_allclose([float(r.pobj) for r in out], refs,
                               atol=1e-3 * (1 + np.abs(refs).max()))


def test_conic_workspace_shard_full_solve(rng):
    """The conic DR/ADMM loop iterates distributed: a sharded conic
    solve (CG Schur path, A row-sharded) matches the unsharded CG solve
    and the known optimum."""
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    from benchmarks.conic_mini import randcone

    from abip import ConeSpec
    from abip.qcp import ConicWorkspace, conic_defaults

    ndev = len(jax.devices())
    m = 8 * ndev
    cones = ConeSpec(soc=(10,), rsoc=(5,), nonneg=3 * m + 9)
    _, A, b, c, cn, star = randcone("sh", m, cones, seed=5)
    import dataclasses

    # replace BEFORE resolved(): derived tolerances follow eps
    s = dataclasses.replace(conic_defaults(), eps=1e-6, linsys="cg")
    base = ConicWorkspace(A, b, c, cn, settings=s).solve()
    mesh = Mesh(np.array(jax.devices()), ("rows",))
    sh = ConicWorkspace(A, b, c, cn, settings=s).shard(mesh).solve()
    assert sh.status_name.startswith("Solved")
    assert sh.pobj == pytest.approx(star, abs=1e-4 * (1 + abs(star)))
    assert abs(sh.admm_iters - base.admm_iters) <= max(
        5, 0.05 * base.admm_iters)


def test_conic_shard_requires_cg(rng):
    from benchmarks.conic_mini import randcone

    from abip import ConeSpec
    from abip.qcp import ConicWorkspace

    _, A, b, c, cn, _ = randcone("d", 8, ConeSpec(soc=(5,), nonneg=19), 3)
    w = ConicWorkspace(A, b, c, cn)   # dense Schur default at this size
    mesh = Mesh(np.array(jax.devices()), ("rows",))
    with pytest.raises(ValueError, match="CG Schur"):
        w.shard(mesh)
