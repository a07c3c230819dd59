"""Operator tests: sparse layouts, the f32 sprint engines, and the
roofline table."""
import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from abip.ops import BCSRMatrix, bcsr_matvec


@pytest.mark.parametrize("m,n,density", [(20, 50, 0.2), (100, 300, 0.05),
                                         (8, 128, 1.0), (17, 260, 0.3)])
def test_bcsr_matvec_matches_dense(rng, m, n, density):
    A = sp.random(m, n, density=density, random_state=np.random.RandomState(0),
                  format="csr")
    x = rng.standard_normal(n)
    B = BCSRMatrix.from_scipy(A, dtype=jnp.float32)
    y_ref = A @ x

    y_xla = np.asarray(bcsr_matvec(B, jnp.asarray(x)))
    np.testing.assert_allclose(y_xla, y_ref, rtol=1e-5, atol=1e-5)


def test_bcsr_packing_stats(rng):
    A = sp.random(64, 512, density=0.1, random_state=np.random.RandomState(1))
    B = BCSRMatrix.from_scipy(A)
    assert B.shape == (64, 512)
    assert B.nnz == A.nnz
    assert B.data.shape[2:] == (8, 128)


def test_fused_admm_sprint_matches_hsd(rng):
    """The in-kernel sprint must reproduce T steps of hsd math (in f32)."""
    from abip import hsd
    from abip.ops.admm_sprint import fused_admm_sprint

    m, n = 8, 24
    l = m + n + 1
    A = jnp.asarray(rng.standard_normal((m, n)), jnp.float32)
    rho_y = 1e-3
    N = rho_y * jnp.eye(m, dtype=jnp.float32) + A @ A.T
    Ninv = jnp.linalg.inv(N.astype(jnp.float64)).astype(jnp.float32)
    b = jnp.asarray(rng.standard_normal(m), jnp.float32)
    c = jnp.asarray(rng.standard_normal(n), jnp.float32)
    h = jnp.concatenate([-b, c, jnp.zeros(1, jnp.float32)])
    gv = jnp.linalg.solve(N.astype(jnp.float64),
                          (h[:m] + A @ h[m:l - 1]).astype(jnp.float64))
    g_x = A.T.astype(jnp.float64) @ gv - h[m:l - 1].astype(jnp.float64)
    g = jnp.concatenate([gv, -g_x, jnp.zeros(1)]).astype(jnp.float32)
    g_th = jnp.dot(h[:l - 1], g[:l - 1])

    u0 = jnp.concatenate([jnp.zeros(m), jnp.ones(n + 1)]).astype(jnp.float32)
    lam, alpha, T = 0.1, 1.8, 7

    # reference trajectory via hsd (f32 operands; exact N^-1 solve)
    def solve_fn(w_y, w_x, k, warm):
        z_y = Ninv @ (w_y + A @ w_x)
        z_x = A.T @ z_y - w_x
        return z_y, z_x, jnp.zeros((), jnp.int32)

    u_ref, v_ref = u0, u0
    for _ in range(T):
        u_t, _ = hsd.project_lin_sys(u_ref, v_ref, h[:l - 1], g[:l - 1],
                                     g_th, rho_y, solve_fn, 0, m, n)
        u_ref, v_ref = hsd.admm_update(u_ref, v_ref, u_ref, u_t, lam, alpha, m)

    u_k, v_k = fused_admm_sprint(A, Ninv, h, g, rho_y, g_th, lam, alpha,
                                 u0, u0, T=T)
    np.testing.assert_allclose(np.asarray(u_k), np.asarray(u_ref),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(v_k), np.asarray(v_ref),
                               rtol=2e-5, atol=2e-5)


def test_ell_matvec_matches_dense(rng):
    import scipy.sparse as sp

    from abip.ops.ell import ELLMatrix, ell_matvec

    A = sp.random(50, 120, density=0.05, random_state=np.random.RandomState(0),
                  format="csr")
    E = ELLMatrix.from_scipy(A)
    x = rng.standard_normal(120)
    np.testing.assert_allclose(np.asarray(ell_matvec(E, jnp.asarray(x))),
                               A @ x, rtol=1e-12, atol=1e-12)


def test_sprint_engine_solves_batch(rng):
    """engine='sprint' (fused T-iteration sprints through the bulk, anchored
    steps for the endgame) reaches the same optima as engine='steps'."""
    import jax.numpy as jnp

    from abip.parallel.batched import solve_lp_batch
    from tests.conftest import random_lp
    from scipy.optimize import linprog

    B, m, n = 3, 20, 60
    As, bs, cs, refs = [], [], [], []
    for i in range(B):
        A, b, c = random_lp(np.random.default_rng(100 + i), m, n)
        As.append(A); bs.append(b); cs.append(c)
        refs.append(linprog(c, A_eq=A, b_eq=b, bounds=(0, None),
                            method="highs").fun)
    res = solve_lp_batch(jnp.asarray(np.stack(As)), jnp.asarray(np.stack(bs)),
                         jnp.asarray(np.stack(cs)), eps=1e-6,
                         precision="mixed", engine="sprint", sprint_T=16)
    for i in range(B):
        assert int(res.status[i]) == 1
        assert float(res.pobj[i]) == pytest.approx(
            refs[i], abs=1e-4 * (1 + abs(refs[i])))


def test_sprint_engine_requires_mixed():
    import jax.numpy as jnp

    from abip.parallel.batched import device_solve_lp

    A = jnp.eye(2)
    with pytest.raises(ValueError, match="requires precision='mixed'"):
        device_solve_lp(A, jnp.ones(2), jnp.ones(2), engine="sprint")


def test_qcp_iteration_cost_model():
    """Conic roofline sanity: Woodbury dual form (2m <= n) costs less
    than the primal form; ceilings are positive and finite."""
    from abip.utils.roofline import qcp_iteration_cost

    kind = "NVIDIA H100 80GB HBM3"
    dual = qcp_iteration_cost(100, 1000, form="auto", device_kind=kind)
    primal = qcp_iteration_cost(100, 1000, form="primal", device_kind=kind)
    assert dual.bytes_moved < primal.bytes_moved
    assert 0 < dual.ceiling_iters_per_sec < float("inf")
    # thinning the inner criterion strictly lowers bytes per iteration
    thin = qcp_iteration_cost(100, 1000, inner_crit_period=8,
                              device_kind=kind)
    dense = qcp_iteration_cost(100, 1000, inner_crit_period=1,
                               device_kind=kind)
    assert thin.bytes_moved < dense.bytes_moved


def test_sprint_stop_matches_hsd_and_stops(rng):
    """fused_admm_sprint_stop with thresh=0 must reproduce T steps of the
    hsd math (f32); with a huge thresh it must stop after one probe."""
    from abip import hsd
    from abip.ops.admm_sprint import fused_admm_sprint_stop

    m, n = 8, 24
    l = m + n + 1
    A = jnp.asarray(rng.standard_normal((m, n)), jnp.float32)
    rho_y = 1e-3
    N = rho_y * jnp.eye(m, dtype=jnp.float32) + A @ A.T
    Ninv = jnp.linalg.inv(N.astype(jnp.float64)).astype(jnp.float32)
    b = jnp.asarray(rng.standard_normal(m), jnp.float32)
    c = jnp.asarray(rng.standard_normal(n), jnp.float32)
    h = jnp.concatenate([-b, c])
    gv = jnp.linalg.solve(N.astype(jnp.float64),
                          (h[:m] + A @ h[m:]).astype(jnp.float64))
    g_x = A.T.astype(jnp.float64) @ gv - h[m:].astype(jnp.float64)
    g = jnp.concatenate([gv, -g_x]).astype(jnp.float32)
    g_th = jnp.dot(h, g)
    u0 = jnp.concatenate([jnp.zeros(m), jnp.ones(n + 1)]).astype(jnp.float32)
    lam, alpha, T = 0.1, 1.8, 8

    def solve_fn(w_y, w_x, k, warm):
        z_y = Ninv @ (w_y + A @ w_x)
        z_x = A.T @ z_y - w_x
        return z_y, z_x, jnp.zeros((), jnp.int32)

    u_ref, v_ref = u0, u0
    for _ in range(T):
        u_t, _ = hsd.project_lin_sys(u_ref, v_ref, h, g, g_th, rho_y,
                                     solve_fn, 0, m, n)
        u_ref, v_ref = hsd.admm_update(u_ref, v_ref, u_ref, u_t, lam,
                                       alpha, m)

    u_k, v_k, t_k, q_k = fused_admm_sprint_stop(
        A, Ninv, h, g, rho_y, g_th, lam, alpha, 0.0, u0, u0, T=T, probe=4)
    assert int(t_k) == T
    assert float(q_k) > 0
    np.testing.assert_allclose(np.asarray(u_k), np.asarray(u_ref),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(v_k), np.asarray(v_ref),
                               rtol=2e-5, atol=2e-5)
    # huge threshold: the in-loop stop fires at the first probe
    _, _, t_s, _ = fused_admm_sprint_stop(
        A, Ninv, h, g, rho_y, g_th, lam, alpha, 1e9, u0, u0, T=T, probe=4)
    assert int(t_s) == 4


def test_lp_iteration_cost_model():
    """LP roofline: the mixed mode streams f32 A (half the f64 bytes),
    and the f64 ceiling uses the f64 peak, not a fraction of f32."""
    from abip.utils.roofline import device_peaks, lp_iteration_cost

    kind = "NVIDIA H100 80GB HBM3"
    mixed = lp_iteration_cost(50, 2000, precision="mixed", device_kind=kind)
    f64 = lp_iteration_cost(50, 2000, precision="f64", device_kind=kind)
    assert f64.bytes_moved == pytest.approx(2 * mixed.bytes_moved)
    peaks = device_peaks(kind)
    assert f64.ceiling_iters_per_sec_flops == pytest.approx(
        peaks["f64_tflops"] * 1e12 / f64.flops)


def test_roofline_unknown_device_raises():
    """A device kind with no published peaks is an error, not a default."""
    from abip.utils.roofline import device_peaks, lp_iteration_cost

    assert device_peaks("NVIDIA H100 80GB HBM3")["hbm_gbps"] == 3350.0
    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks("cpu")
    with pytest.raises(KeyError):
        lp_iteration_cost(50, 2000, device_kind="NVIDIA A100-SXM4-80GB")


def test_sprint2_engine_solves_batch(rng):
    """engine='sprint2' (two-phase: stopping-sprint bulk + anchored-f64
    endgame) reaches the scipy optima at 1e-6 with honest per-lane
    iteration counts carried across the phase hand-off."""
    import jax.numpy as jnp
    from scipy.optimize import linprog

    from abip.parallel.batched import solve_lp_batch
    from tests.conftest import random_lp

    B, m, n = 3, 20, 60
    As, bs, cs, refs = [], [], [], []
    for i in range(B):
        A, b, c = random_lp(np.random.default_rng(200 + i), m, n)
        As.append(A); bs.append(b); cs.append(c)
        refs.append(linprog(c, A_eq=A, b_eq=b, bounds=(0, None),
                            method="highs").fun)
    res = solve_lp_batch(jnp.asarray(np.stack(As)), jnp.asarray(np.stack(bs)),
                         jnp.asarray(np.stack(cs)), eps=1e-6,
                         precision="mixed", solver="inverse",
                         engine="sprint2", qres_period=256, probe_period=8)
    for i in range(B):
        assert int(res.status[i]) == 1
        assert int(res.admm_iters[i]) > 0
        assert float(res.rel_gap[i]) < 1.05e-6
        assert float(res.pobj[i]) == pytest.approx(
            refs[i], abs=1e-4 * (1 + abs(refs[i])))


def test_sprint2_terminates_on_ipm_cap(rng):
    """A lane that exits device_solve_lp via the max_ipm cap (status 0,
    admm_iters < max_admm) must still be marked finished by the phase-2
    compaction loop -- with the cap unhandled the host `while active.size`
    loop re-ran the lane forever (advisor finding, round 3)."""
    import jax.numpy as jnp

    from abip.parallel.batched import solve_lp_batch
    from tests.conftest import random_lp

    B, m, n = 3, 20, 60
    As, bs, cs = [], [], []
    for i in range(B):
        A, b, c = random_lp(np.random.default_rng(300 + i), m, n)
        As.append(A); bs.append(b); cs.append(c)
    res = solve_lp_batch(jnp.asarray(np.stack(As)), jnp.asarray(np.stack(bs)),
                         jnp.asarray(np.stack(cs)), eps=1e-6,
                         precision="mixed", solver="inverse",
                         engine="sprint2", qres_period=256, probe_period=8,
                         max_ipm=2)
    # must return (not hang); capped lanes come back status 0 with their
    # partial iterate, exactly like the whole-batch path did pre-compaction
    for i in range(B):
        assert int(res.status[i]) in (0, 1)
        assert int(res.ipm_iters[i]) <= 2 or int(res.status[i]) == 1


def test_mu_stop_and_init_state_resume(rng):
    """mu_stop exits the outer loop at the phase boundary with status 0;
    resuming via init_state finishes the solve with accumulated
    iteration counters."""
    import jax.numpy as jnp

    from abip.parallel.batched import device_solve_lp
    from tests.conftest import random_lp

    A, b, c = random_lp(np.random.default_rng(11), 15, 45)
    A, b, c = jnp.asarray(A), jnp.asarray(b), jnp.asarray(c)
    kw = dict(eps=1e-6, precision="mixed", solver="inverse",
              qres_period=64, probe_period=8, cadence="chunk")
    r1 = device_solve_lp(A, b, c, mu_stop=1e-3, **kw)
    assert int(r1.status) == 0
    assert float(r1.mu) < 1e-3
    assert int(r1.admm_iters) > 0
    r2 = device_solve_lp(
        A, b, c,
        init_state=(r1.u_raw, r1.v_raw, r1.mu, r1.admm_iters,
                    r1.ipm_iters, r1.status), **kw)
    assert int(r2.status) == 1
    assert int(r2.admm_iters) > int(r1.admm_iters)
    assert float(r2.rel_gap) < 1.05e-6
