"""Restarted-PDHG competitor solver: golden-oracle and integration tests.

Covers the native analogue of the reference's external PDLP driver
(`/root/reference/scripts/bench-lp/pdlp_solve.py`): objective parity with
scipy linprog (HiGHS), KKT quality of the returned triple, and the MPS
suite-runner integration (`solve_mps(method="pdhg")`).
"""
import numpy as np
import pytest
from scipy.optimize import linprog

from abip.pdhg import estimate_spectral_norm, solve_lp_pdhg


def random_lp(seed, m, n):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    b = A @ (rng.random(n) + 0.5)
    c = A.T @ rng.standard_normal(m) + rng.random(n) + 0.5
    return A, b, c


@pytest.mark.parametrize("seed,m,n", [(3, 30, 90), (0, 50, 200),
                                      (11, 40, 400)])
def test_pdhg_matches_scipy(seed, m, n):
    A, b, c = random_lp(seed, m, n)
    sol = solve_lp_pdhg(A, b, c, eps=1e-6)
    ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, None), method="highs")
    assert sol.status_name == "Solved"
    assert abs(sol.pobj - ref.fun) / max(1.0, abs(ref.fun)) < 1e-4


def test_pdhg_kkt_quality():
    A, b, c = random_lp(5, 25, 80)
    sol = solve_lp_pdhg(A, b, c, eps=1e-7)
    # primal feasibility
    assert np.linalg.norm(A @ sol.x - b) / (1 + np.linalg.norm(b)) < 1e-6
    assert sol.x.min() > -1e-9
    # dual feasibility: s = c - A'y >= 0 (up to tolerance)
    assert sol.s.min() > -1e-5
    # reported residuals consistent with the eps contract
    assert sol.res_pri < 1e-7 and sol.res_dual < 1e-7 and sol.rel_gap < 1e-7
    # the reported residuals must belong to the RETURNED iterate (the
    # convergence-forces-restart rule): recomputing pres from sol.x
    # reproduces res_pri exactly
    recomputed = np.linalg.norm(A @ sol.x - b) / (1 + np.linalg.norm(b))
    assert recomputed == pytest.approx(sol.res_pri, rel=1e-10)


def test_spectral_norm_estimate():
    rng = np.random.default_rng(2)
    A = rng.standard_normal((40, 60))
    est = float(estimate_spectral_norm(np.asarray(A)))
    true = np.linalg.norm(A, 2)
    # power iteration converges from below; the 0.9 stepsize margin in
    # solve_lp_pdhg absorbs up to 10% underestimate
    assert est <= true * (1 + 1e-9)
    assert (true - est) / true < 0.05


def test_pdhg_via_mps(tmp_path):
    import scipy.sparse as sp

    from abip.io.mps import GeneralLP
    from abip.io.mps_write import write_mps
    from abip.io.presolve import solve_mps

    A, b, c = random_lp(9, 12, 30)
    m, n = A.shape
    p = GeneralLP(c=c, A=sp.csc_matrix(A), row_lo=b, row_hi=b,
                  lb=np.zeros(n), ub=np.full(n, np.inf))
    path = tmp_path / "pd.mps"
    write_mps(p, str(path))
    sol, _ = solve_mps(str(path), method="pdhg", eps=1e-6)
    ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, None), method="highs")
    assert sol.status_name == "Solved"
    assert abs(sol.pobj - ref.fun) / max(1.0, abs(ref.fun)) < 1e-4


def test_pdhg_mixed_precision_trajectory():
    """Anchored f32-delta matvecs reproduce the f64 trajectory: same
    iteration count and the same (eps-consistent) solution."""
    A, b, c = random_lp(0, 50, 200)
    s64 = solve_lp_pdhg(A, b, c, eps=1e-6, precision="f64")
    smx = solve_lp_pdhg(A, b, c, eps=1e-6, precision="mixed")
    assert smx.status_name == "Solved"
    assert smx.admm_iters == s64.admm_iters
    assert abs(smx.pobj - s64.pobj) < 1e-6 * (1 + abs(s64.pobj))

    with pytest.raises(ValueError):
        solve_lp_pdhg(A, b, c, precision="f32")


@pytest.mark.parametrize("seed", [0, 1])
def test_pdhg_detects_infeasible(seed):
    from benchmarks.generate import infeasible_lp

    A, b, c = infeasible_lp(seed=seed)
    sol = solve_lp_pdhg(A, b, c, eps=1e-6, max_iters=100_000)
    assert sol.status_name == "Infeasible"
    assert sol.res_infeas < 1e-7


@pytest.mark.parametrize("seed", [0, 1])
def test_pdhg_detects_unbounded(seed):
    from benchmarks.generate import unbounded_lp

    A, b, c = unbounded_lp(seed=seed)
    sol = solve_lp_pdhg(A, b, c, eps=1e-6, max_iters=100_000)
    assert sol.status_name == "Unbounded"
    assert sol.res_unbdd < 1e-7


def test_pdhg_batch_matches_single_and_shards():
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from abip.pdhg import solve_lp_pdhg_batch

    B, m, n = 4, 15, 45
    rng = np.random.default_rng(1)
    As, bs, cs = [], [], []
    for _ in range(B):
        A, b, c = (lambda A, x0: (A, A @ x0,
                                  A.T @ rng.standard_normal(m)
                                  + rng.random(n) + 0.5))(
            rng.standard_normal((m, n)), rng.random(n) + 0.5)
        As.append(A), bs.append(b), cs.append(c)
    As, bs, cs = map(np.stack, (As, bs, cs))

    st = solve_lp_pdhg_batch(As, bs, cs, eps=1e-6)
    assert (np.asarray(st.status) == 1).all()

    mesh = Mesh(np.array(jax.devices()[:4]), ("batch",))
    st2 = solve_lp_pdhg_batch(As, bs, cs, eps=1e-6, mesh=mesh)
    # sharded compilation may reorder reductions; agreement to 1e-8 is
    # the contract (both solve the same instance to eps=1e-6)
    np.testing.assert_allclose(np.asarray(st.pobj), np.asarray(st2.pobj),
                               rtol=1e-8)

    s0 = solve_lp_pdhg(As[0], bs[0], cs[0], eps=1e-6, precision="mixed")
    assert abs(float(np.asarray(st.pobj)[0]) - s0.pobj) < 1e-9


# ---------------- conic PDHG (SCS competitor role) -------------------- #

def test_conic_pdhg_mixed_cones_oracle():
    """Conic PDHG solves randcone instances (known optimum) across SOC/
    RSOC/free/nonneg mixes."""
    from benchmarks.conic_mini import randcone

    from abip import ConeSpec
    from abip.pdhg import solve_qcp_pdhg

    for seed, cones in [(1, ConeSpec(soc=(6, 4), nonneg=15)),
                        (2, ConeSpec(rsoc=(5,), free=2, nonneg=10)),
                        (3, ConeSpec(soc=(5,), rsoc=(4,), nonneg=12))]:
        name, A, b, c, cn, star = randcone(f"p{seed}", 12, cones, seed)
        sol = solve_qcp_pdhg(A, b, c, cn, eps=1e-7)
        assert sol.status_name == "Solved"
        assert abs(sol.pobj - star) / (1 + abs(star)) < 1e-5
        # primal must be (near-)feasible for the cones
        from abip.cones import ConeLayout, cone_membership_violation
        import jax.numpy as jnp
        viol = float(cone_membership_violation(jnp.asarray(sol.x),
                                               ConeLayout(cn)))
        assert viol < 1e-5


def test_conic_pdhg_agrees_with_admm_portfolio():
    """PDHG and the ADMM conic driver agree on the portfolio SOCP."""
    from benchmarks.conic_mini import portfolio

    from abip.pdhg import solve_qcp_pdhg
    from abip.qcp import solve_qcp

    name, A, b, c, cones, _ = portfolio(20, 5, 9)
    p = solve_qcp_pdhg(A, b, c, cones, eps=1e-7)
    a = solve_qcp(A, b, c, cones, eps=1e-7)
    assert p.status_name == "Solved" and a.status_name == "Solved"
    assert abs(p.pobj - a.pobj) / (1 + abs(a.pobj)) < 1e-5


def test_conic_pdhg_detects_infeasible():
    """x in SOC(3) forces x1 >= 0; the row x1 = -1 is infeasible."""
    from abip import ConeSpec
    from abip.pdhg import solve_qcp_pdhg

    A = np.array([[1.0, 0.0, 0.0]])
    b = np.array([-1.0])
    c = np.array([0.0, 1.0, 1.0])
    sol = solve_qcp_pdhg(A, b, c, ConeSpec(soc=(3,)), eps=1e-6,
                         max_iters=50_000)
    assert sol.status_name == "Infeasible"


def test_conic_pdhg_mixed_precision_and_batch():
    """mixed precision matches f64 objective; the vmapped batch matches
    the single-instance path."""
    from benchmarks.conic_mini import randcone

    from abip import ConeSpec
    from abip.pdhg import solve_qcp_pdhg, solve_qcp_pdhg_batch

    cones = ConeSpec(soc=(4,), nonneg=8)
    insts = [randcone(f"b{s}", 6, cones, 20 + s) for s in range(3)]
    sols = [solve_qcp_pdhg(A, b, c, cones, eps=1e-6)
            for _, A, b, c, _, _ in insts]
    mix = solve_qcp_pdhg(*insts[0][1:4], cones, eps=1e-6,
                         precision="mixed")
    assert abs(mix.pobj - sols[0].pobj) / (1 + abs(sols[0].pobj)) < 1e-5

    As = np.stack([i[1] for i in insts])
    bs = np.stack([i[2] for i in insts])
    cs = np.stack([i[3] for i in insts])
    st = solve_qcp_pdhg_batch(As, bs, cs, cones, eps=1e-6,
                              precision="f64")
    assert all(int(s) == 1 for s in np.asarray(st.status))
    for k, s in enumerate(sols):
        lane_obj = float(np.asarray(st.pobj)[k])
        assert abs(lane_obj - s.pobj) / (1 + abs(s.pobj)) < 1e-6
