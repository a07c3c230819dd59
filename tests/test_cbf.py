"""CBF (CBLIB Conic Benchmark Format) reader/writer tests.

Oracles: analytic conic optima for hand-written CBF text, scipy linprog
for LP-shaped instances, and exact round-trips through write_cbf.
Protocol role: `/root/reference/scripts/bench-qcp/test_cblib.m` (which
needs the Mosek reader; ours is native).
"""
import numpy as np
import pytest

from abip.io.cbf import (cbf_to_conic, parse_cbf, read_cbf, solve_cbf,
                             write_cbf)

# -- hand-written CBF instances --------------------------------------

# max x1 + x2  s.t. ||(x1, x2)|| <= 2  (t fixed by an L= row), vars free.
# optimum x1 = x2 = sqrt(2), objective 2*sqrt(2).
SOC_MAX = """\
# tiny SOC test instance
VER
2

OBJSENSE
MAX

VAR
3 1
F 3

CON
4 2
L= 1
Q 3

OBJACOORD
2
1 1.0
2 1.0

ACOORD
4
0 0 1.0
1 0 1.0
2 1 1.0
3 2 1.0

BCOORD
1
0 -2.0
"""

# min x1 + 2 x2 s.t. x1 + x2 >= 1 (L+ row), x1 >= 0, x2 <= 0 (L- var).
# optimum: x2 = 0 forced? x2 <= 0 and c2 = +2 pushes x2 down, but the
# row x1 + x2 >= 1 then needs x1 >= 1 - x2; total c'x = x1 + 2 x2 =
# (1 - x2) + 2 x2 = 1 + x2, minimized by x2 -> -inf UNLESS x1 is
# bounded: add x1 <= 3 (L- row: x1 - 3 <= 0).  Then x2 = 1 - x1 >= -2
# at x1 = 3, objective 3 + 2(-2) = -1.
LP_SIGNS = """\
VER
2
OBJSENSE
MIN
VAR
2 2
L+ 1
L- 1
CON
2 2
L+ 1
L- 1
OBJACOORD
2
0 1.0
1 2.0
ACOORD
3
0 0 1.0
0 1 1.0
1 0 1.0
BCOORD
2
0 -1.0
1 -3.0
"""

RSOC_MIN = """\
VER
2
OBJSENSE
MIN
VAR
4 1
QR 4

CON
2 1
L= 2

OBJACOORD
1
1 1.0

ACOORD
3
0 0 1.0
1 2 1.0
1 3 1.0

BCOORD
2
0 -1.0
1 -2.0
"""

INT_INSTANCE = """\
VER
2
OBJSENSE
MIN
VAR
1 1
L+ 1
INT
1
0
OBJACOORD
1
0 1.0
"""


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    import jax

    jax.config.update("jax_platforms", "cpu")


def test_parse_soc_max():
    p = parse_cbf(SOC_MAX)
    assert p.objsense == "MAX"
    assert p.var_cones == [("F", 3)]
    assert p.con_cones == [("L=", 1), ("Q", 3)]
    assert p.n == 3 and p.m == 4
    assert p.obj_a == {1: 1.0, 2: 1.0}
    assert p.b_coord == {0: -2.0}


def test_embedding_shapes_soc():
    emb = cbf_to_conic(parse_cbf(SOC_MAX))
    # 3 free vars + 3 SOC slack columns; 4 equality rows
    assert emb.A.shape == (4, 6)
    assert emb.cones.soc == (3,) and emb.cones.free == 3
    assert emb.cones.dim == 6


def test_solve_soc_max_analytic(tmp_path):
    path = tmp_path / "soc.cbf"
    path.write_text(SOC_MAX)
    sol, x, obj = solve_cbf(str(path), eps=1e-7)
    assert "Solved" in sol.status_name
    np.testing.assert_allclose(x[0], 2.0, atol=1e-5)
    np.testing.assert_allclose(x[1:], np.sqrt(2.0), atol=1e-4)
    np.testing.assert_allclose(obj, 2.0 * np.sqrt(2.0), atol=1e-4)


def test_solve_lp_signs_vs_scipy(tmp_path):
    from scipy.optimize import linprog

    path = tmp_path / "lp.cbf"
    path.write_text(LP_SIGNS)
    sol, x, obj = solve_cbf(str(path), eps=1e-7)
    ref = linprog([1.0, 2.0], A_ub=[[-1.0, -1.0], [1.0, 0.0]],
                  b_ub=[-1.0, 3.0], bounds=[(0, None), (None, 0)],
                  method="highs")
    assert "Solved" in sol.status_name
    np.testing.assert_allclose(obj, ref.fun, atol=1e-5)
    np.testing.assert_allclose(x, ref.x, atol=1e-5)
    assert x[1] <= 1e-7  # the L- variable really is nonpositive


def test_solve_rsoc_analytic(tmp_path):
    # min x2 s.t. x1 = 1, x3 + x4 = 2, 2 x1 x2 >= x3^2 + x4^2.
    # At optimum x3 = x4 = 1 (symmetric), x2 = (x3^2+x4^2)/2 = 1.
    path = tmp_path / "rsoc.cbf"
    path.write_text(RSOC_MIN)
    sol, x, obj = solve_cbf(str(path), eps=1e-7)
    assert "Solved" in sol.status_name
    np.testing.assert_allclose(x, [1.0, 1.0, 1.0, 1.0], atol=1e-4)
    np.testing.assert_allclose(obj, 1.0, atol=1e-4)


def test_integer_rejected_unless_relaxed(tmp_path):
    path = tmp_path / "int.cbf"
    path.write_text(INT_INSTANCE)
    with pytest.raises(ValueError, match="integer"):
        read_cbf(str(path))
    emb = read_cbf(str(path), relax_integrality=True)
    assert emb.cones.nonneg == 1


def test_unsupported_sections_raise():
    with pytest.raises(ValueError, match="PSDVAR"):
        parse_cbf("VER\n2\nPSDVAR\n1\n3\n")
    with pytest.raises(ValueError, match="EXP"):
        parse_cbf("VER\n2\nVAR\n3 1\nEXP 3\n")
    with pytest.raises(ValueError, match="missing VER"):
        parse_cbf("OBJSENSE\nMIN\nVAR\n1 1\nL+ 1\n")
    with pytest.raises(ValueError, match="sum to"):
        parse_cbf("VER\n2\nVAR\n3 1\nL+ 2\n")


def test_roundtrip_randcone(tmp_path):
    """write_cbf -> read_cbf reproduces the exact standard form, and the
    solved objective matches the generator's known optimum."""
    from benchmarks.conic_mini import randcone

    from abip import ConeSpec
    from abip.dispatch import solve

    cones = ConeSpec(soc=(5, 4), rsoc=(3,), free=2, nonneg=10)
    name, A, b, c, cn, pobj_star = randcone("rt", 8, cones, seed=3)
    path = tmp_path / "rt.cbf"
    write_cbf(str(path), A, b, c, cn, comment="round-trip")
    emb = read_cbf(str(path))
    np.testing.assert_allclose(emb.A, A, rtol=0, atol=0)
    np.testing.assert_allclose(emb.b, b, rtol=0, atol=0)
    np.testing.assert_allclose(emb.c, c, rtol=0, atol=0)
    assert emb.cones == cn

    sol = solve(emb.A, emb.b, emb.c, cones=emb.cones, eps=1e-6)
    assert "Solved" in sol.status_name
    np.testing.assert_allclose(emb.objective(float(sol.pobj)), pobj_star,
                               atol=2e-4, rtol=1e-4)


def test_committed_suite_sample():
    """A sample of the committed cblib-mini suite solves to its stored
    optimum through `run_suite --cbf` (host route)."""
    import glob
    import os

    from benchmarks.run_suite import run_cbf

    suite = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                         "suites", "cblib_mini")
    paths = [p for p in sorted(glob.glob(os.path.join(suite, "*.cbf")))
             if os.path.basename(p).startswith(("rand_rsoc_a_rows",
                                                "rand_soc_b_max"))]
    assert len(paths) == 2, "expected committed suite files"
    recs = run_cbf(paths, 1e-6, None)
    for rec in recs:
        assert rec["status"] == "Solved", rec
        assert rec["obj_err"] < 1e-5, rec


def test_run_cbf_device_route(tmp_path):
    """The device route (`run_suite --cbf --device`) agrees with the
    stored optimum on a row-form instance."""
    import glob
    import os

    from benchmarks.run_suite import run_cbf

    suite = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                         "suites", "cblib_mini")
    paths = sorted(glob.glob(os.path.join(suite, "rand_mixed_a_max.cbf")))
    recs = run_cbf(paths, 1e-6, None, device=True)
    assert recs[0]["status"] == "Solved", recs[0]
    assert recs[0]["obj_err"] < 1e-5, recs[0]


def test_roundtrip_objsense_and_const(tmp_path):
    """MAX sense + OBJBCOORD survive a write/read cycle on an LP."""
    rng = np.random.default_rng(5)
    A = np.abs(rng.standard_normal((3, 6))) + 0.1
    x0 = rng.random(6) + 0.5
    b = A @ x0
    c = rng.random(6) + 0.5
    from abip import ConeSpec

    path = tmp_path / "max.cbf"
    write_cbf(str(path), A, b, -c, ConeSpec.lp(6), objsense="MAX",
              obj_b=7.5)
    sol, x, obj = solve_cbf(str(path), eps=1e-7)
    from scipy.optimize import linprog

    ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, None), method="highs")
    # MAX of -c'x + 7.5 == -(MIN of c'x) + 7.5
    np.testing.assert_allclose(obj, -ref.fun + 7.5, atol=1e-5)


def test_free_constraint_rows_dropped():
    """F constraint cones are vacuous (A x + b in R): they impose
    nothing and must be dropped, not treated as equalities."""
    text = """\
VER
2
OBJSENSE
MIN
VAR
1 1
L+ 1
CON
2 2
F 1
L+ 1
OBJACOORD
1
0 1.0
ACOORD
2
0 0 1.0
1 0 1.0
BCOORD
2
0 -5.0
1 -1.0
"""
    emb = cbf_to_conic(parse_cbf(text))
    # 1 var + 1 slack (the L+ row); the F row is gone
    assert emb.A.shape == (1, 2)
    from abip.dispatch import solve

    sol = solve(emb.A, emb.b, emb.c, cones=emb.cones, eps=1e-8)
    # min x s.t. x >= 1 (the F row "x - 5 in R" binds nothing)
    np.testing.assert_allclose(emb.objective(float(sol.pobj)), 1.0,
                               atol=1e-6)


def test_constraint_free_roundtrip(tmp_path):
    """m = 0 instances (pure cone membership) round-trip through
    write_cbf/read_cbf."""
    from abip import ConeSpec

    path = tmp_path / "nocon.cbf"
    c = np.array([1.0, -2.0, 3.0])
    write_cbf(str(path), np.zeros((0, 3)), np.zeros(0), c,
              ConeSpec(soc=(3,)))
    emb = read_cbf(str(path))
    assert emb.A.shape == (0, 3)
    np.testing.assert_allclose(emb.c, c)
    assert emb.cones.soc == (3,)


def test_signature_matches_embedding():
    """embedding_signature (structure-only) agrees with the assembled
    embedding's (shape, cones)."""
    from abip.io.cbf import embedding_signature

    for text in (SOC_MAX, LP_SIGNS, RSOC_MIN):
        p = parse_cbf(text)
        emb = cbf_to_conic(p)
        assert embedding_signature(p) == (emb.A.shape, emb.cones)


def test_device_method_conflict_raises():
    from benchmarks.run_suite import run_cbf, run_sedumi

    with pytest.raises(ValueError, match="mislabeled"):
        run_cbf([], 1e-6, None, device=True, method="pdhg")
    with pytest.raises(ValueError, match="mislabeled"):
        run_sedumi([], 1e-6, None, device=True, method="pdhg")


def test_roundtrip_fuzz(tmp_path):
    """Randomized write->read round-trips across cone mixes (incl. zero
    cones, MAX sense, objective constants): data must survive exactly,
    and the row-form writer must yield the same optimum as the equality
    form on oracle instances."""
    from benchmarks.cblib_mini import write_cbf_rowform
    from benchmarks.conic_mini import randcone

    from abip import ConeSpec
    from abip.dispatch import solve

    rng = np.random.default_rng(17)
    for k in range(8):
        soc = tuple(int(v) for v in rng.integers(2, 6, rng.integers(0, 3)))
        rsoc = tuple(int(v) for v in rng.integers(3, 6, rng.integers(0, 2)))
        cones = ConeSpec(soc=soc, rsoc=rsoc,
                         free=int(rng.integers(0, 3)),
                         zero=int(rng.integers(0, 3)),
                         nonneg=int(rng.integers(1, 8)))
        m = max(2, cones.dim // 3)
        A = rng.standard_normal((m, cones.dim))
        b = rng.standard_normal(m)
        c = rng.standard_normal(cones.dim)
        sense = "MAX" if k % 2 else "MIN"
        obj_b = float(rng.standard_normal()) if k % 3 == 0 else 0.0
        path = tmp_path / f"f{k}.cbf"
        write_cbf(str(path), A, b, c if sense == "MIN" else -c, cones,
                  objsense=sense, obj_b=obj_b)
        emb = read_cbf(str(path))
        sgn = -1.0 if sense == "MAX" else 1.0
        np.testing.assert_array_equal(emb.A, A)
        np.testing.assert_array_equal(emb.b, b)
        # the embedding always MINIMIZES: a MAX file holding -c yields
        # the same embedded c as a MIN file holding c
        np.testing.assert_array_equal(emb.c, c)
        assert emb.cones == cones and emb.obj_b == obj_b
        # objective mapping: solver pobj v -> sense*v + obj_b
        assert emb.objective(2.5) == pytest.approx(sgn * 2.5 + obj_b)

    # row form vs equality form on a solvable oracle instance
    cones = ConeSpec(soc=(5,), rsoc=(4,), nonneg=9)
    _, A, b, c, cn, star = randcone("fz", 7, cones, seed=29)
    p_eq, p_row = tmp_path / "eq.cbf", tmp_path / "row.cbf"
    write_cbf(str(p_eq), A, b, c, cn)
    write_cbf_rowform(str(p_row), A, b, c, cn)
    for p in (p_eq, p_row):
        emb = read_cbf(str(p))
        sol = solve(emb.A, emb.b, emb.c, cones=emb.cones, eps=1e-6)
        assert "Solved" in sol.status_name
        assert abs(emb.objective(float(sol.pobj)) - star) / (
            1 + abs(star)) < 1e-4
