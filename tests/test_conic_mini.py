"""conic-mini suite: SeDuMi writer round-trip + oracle-checked solves.

Mirrors the reference's CBLIB protocol (`test_cblib.m:60-76`): load
SeDuMi-format structs, solve, compare objectives -- here against the
exact complementary-pair / NNLS oracles stored by conic_mini.
"""
import numpy as np
import pytest
import scipy.sparse as sp

from abip.cones import ConeSpec
from abip.io.sedumi import from_sedumi, to_sedumi, write_sedumi_mat

from benchmarks import conic_mini


def test_to_from_sedumi_roundtrip():
    rng = np.random.default_rng(3)
    cones = ConeSpec(soc=(4, 3), rsoc=(5,), free=2, nonneg=6)
    n = cones.dim
    A = rng.standard_normal((7, n))
    b = rng.standard_normal(7)
    c = rng.standard_normal(n)
    As, bs, cs, K = to_sedumi(sp.csc_matrix(A), b, c, cones)
    A2, b2, c2, cones2, perm = from_sedumi(As, bs, cs, K)
    np.testing.assert_allclose(A2, A)
    np.testing.assert_allclose(b2, b)
    np.testing.assert_allclose(c2, c)
    assert cones2 == cones


def test_to_sedumi_rejects_zero_cone():
    cones = ConeSpec(zero=2, nonneg=1)
    A = np.ones((1, 3))
    with pytest.raises(ValueError, match="zero"):
        to_sedumi(A, np.ones(1), np.ones(3), cones)


def test_write_load_solve_with_oracle(tmp_path):
    from abip.io.sedumi import solve_sedumi

    name, A, b, c, cones, pobj_star = conic_mini.randcone(
        "rt", 15, ConeSpec(soc=(5,), nonneg=12), seed=7)
    path = tmp_path / "rt.mat"
    write_sedumi_mat(str(path), sp.csc_matrix(A), b, c, cones,
                     extra={"pobj_star": pobj_star})
    sol = solve_sedumi(str(path), eps=1e-6)
    assert sol.status_name == "Solved"
    assert abs(sol.pobj - pobj_star) / max(1.0, abs(pobj_star)) < 5e-5


def test_complementary_pair_is_valid():
    rng = np.random.default_rng(0)
    cones = ConeSpec(soc=(6, 3), rsoc=(4,), free=3, nonneg=8)
    x, s = conic_mini._complementary_pair(cones, rng)
    assert x.shape == (cones.dim,)
    assert abs(x @ s) < 1e-12
    # block memberships
    q = cones.soc[0]
    assert x[0] >= np.linalg.norm(x[1:q]) - 1e-12
    p, qq = x[9], x[10]  # rsoc head after soc blocks (6+3)
    assert 2 * p * qq >= np.linalg.norm(x[11:13]) ** 2 - 1e-12
    assert (x[-8:] >= 0).all() and (s[-8:] >= 0).all()
    assert np.all((x[-8:] == 0) | (s[-8:] == 0))


def test_nnlsq_oracle_matches_solver():
    from abip.qcp import solve_qcp

    name, A, b, c, cones, pobj_star = conic_mini.nnlsq(10, 18, seed=5)
    sol = solve_qcp(A, b, c, cones, eps=1e-6)
    assert sol.status_name == "Solved"
    assert abs(sol.pobj - pobj_star) < 5e-5 * max(1.0, abs(pobj_star))


def test_randqcp_oracle():
    """randqcp's complementary-pair QP construction: the stated optimum
    is attained by the solver for diagonal, low-rank, and full Q."""
    from benchmarks.conic_mini import randqcp

    from abip import ConeSpec
    from abip.qcp import solve_qcp

    for q_kind, cones in ((None, ConeSpec(soc=(5,), nonneg=10)),
                          ("diag", ConeSpec(nonneg=12)),
                          (2, ConeSpec(rsoc=(4,), nonneg=8))):
        nm, A, b, c, Q, cn, star = randqcp("t", 6, cones, 7, q_rank=q_kind)
        sol = solve_qcp(A, b, c, cn, Q=Q, eps=1e-7)
        assert sol.status_name == "Solved"
        assert abs(sol.pobj - star) / (1 + abs(star)) < 1e-5
