"""Native C++ MPS parser: parity with the Python reader."""
import numpy as np
import pytest

from abip.io import read_mps
from abip.io.native import native_available, read_mps_native
from tests.test_io import SAMPLE_MPS


@pytest.fixture
def sample_path(tmp_path):
    f = tmp_path / "sample.mps"
    f.write_text(SAMPLE_MPS)
    return str(f)


needs_native = pytest.mark.skipif(not native_available(),
                                  reason="native parser not built")


@needs_native
def test_native_matches_python(sample_path):
    p1 = read_mps(sample_path, prefer_native="never")
    p2 = read_mps_native(sample_path)
    assert p1.col_names == p2.col_names
    assert p1.row_names == p2.row_names
    assert p1.maximize == p2.maximize
    np.testing.assert_allclose(p1.c, p2.c)
    np.testing.assert_allclose(p1.row_lo, p2.row_lo)
    np.testing.assert_allclose(p1.row_hi, p2.row_hi)
    np.testing.assert_allclose(p1.lb, p2.lb)
    np.testing.assert_allclose(p1.ub, p2.ub)
    np.testing.assert_allclose(p1.A.toarray(), p2.A.toarray())


@needs_native
def test_native_error_paths(tmp_path):
    with pytest.raises(ValueError, match="cannot open"):
        read_mps_native(str(tmp_path / "missing.mps"))
    bad = tmp_path / "bad.mps"
    bad.write_text("ROWS\n blah\n")
    with pytest.raises(ValueError, match="parse error|no objective"):
        read_mps_native(str(bad))
    integer = tmp_path / "int.mps"
    integer.write_text(SAMPLE_MPS.replace(
        "    X1  COST  1.0   R1  1.0",
        "    M1  'MARKER'  'INTORG'\n    X1  COST  1.0   R1  1.0"))
    with pytest.raises(ValueError, match="continuous"):
        read_mps_native(str(integer))


@needs_native
def test_prefer_native_always(sample_path):
    p = read_mps(sample_path, prefer_native="always")
    np.testing.assert_allclose(p.c, [1.0, 2.0, -1.0])


@needs_native
def test_native_bounds_without_set_name(tmp_path):
    """3-token 'BTYPE COL VAL' BOUNDS lines parse in the C++ reader too."""
    mps = SAMPLE_MPS.replace(
        " UP BND  X1  8.0\n LO BND  X2  -2.0\n FR BND  X3\n",
        " UP X1  8.0\n LO X2  -2.0\n FR X3\n",
    )
    f = tmp_path / "noset.mps"
    f.write_text(mps)
    p = read_mps_native(str(f))
    np.testing.assert_allclose(p.lb, [0.0, -2.0, -np.inf])
    np.testing.assert_allclose(p.ub, [8.0, np.inf, np.inf])


@needs_native
def test_native_bounds_errors(tmp_path):
    f = tmp_path / "noval.mps"
    f.write_text(SAMPLE_MPS.replace(" UP BND  X1  8.0", " UP BND  X1"))
    with pytest.raises(ValueError, match="needs value"):
        read_mps_native(str(f))
    g = tmp_path / "unkcol.mps"
    g.write_text(SAMPLE_MPS.replace(" UP BND  X1  8.0", " UP BND  NOPE  8.0"))
    with pytest.raises(ValueError, match="unknown column"):
        read_mps_native(str(g))


@needs_native
def test_native_cbf_matches_python():
    """The C++ CBF parser reproduces the Python parse exactly on every
    committed cblib-mini instance (sections, cones, coords, sense)."""
    import glob
    import os

    from abip.io.cbf import parse_cbf
    from abip.io.native import parse_cbf_native

    suite = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                         "suites", "cblib_mini")
    paths = sorted(glob.glob(os.path.join(suite, "*.cbf")))
    assert len(paths) == 12
    for p in paths:
        py = parse_cbf(p)
        nat = parse_cbf_native(p)
        assert nat.objsense == py.objsense
        assert nat.var_cones == py.var_cones
        assert nat.con_cones == py.con_cones
        assert (nat.n, nat.m) == (py.n, py.m)
        assert nat.obj_a == py.obj_a
        assert nat.obj_b == py.obj_b
        assert nat.a_coord == py.a_coord
        assert nat.b_coord == py.b_coord
        assert nat.integers == py.integers


@needs_native
def test_native_cbf_errors():
    import tempfile

    from abip.io.native import parse_cbf_native

    with tempfile.NamedTemporaryFile("w", suffix=".cbf",
                                     delete=False) as f:
        f.write("OBJSENSE\nMIN\nVAR\n1 1\nL+ 1\n")
        path = f.name
    with pytest.raises(ValueError, match="missing VER"):
        parse_cbf_native(path)
    with tempfile.NamedTemporaryFile("w", suffix=".cbf",
                                     delete=False) as f:
        f.write("VER\n2\nPSDVAR\n1\n3\n")
        path = f.name
    with pytest.raises(ValueError, match="PSDVAR"):
        parse_cbf_native(path)


@needs_native
def test_native_cbf_strictness_parity():
    """Malformed numerics must be REJECTED by both parsers identically
    (the native side previously accepted atoll/atof garbage)."""
    import tempfile

    from abip.io.cbf import parse_cbf
    from abip.io.native import parse_cbf_native

    bad = [
        "VER\n2x\nVAR\n1 1\nL+ 1\n",                       # junk version
        "VER\n2\nVAR\n1 1\nL+ 1\nINT\n1\nxyz\n",           # junk INT entry
        "VER\n2\nVAR\n1 1\nL+ 1\nOBJACOORD\n1\n0 2.0 junk\n",  # trailing tok
        "VER\n2\nVAR\n1 1\nL+ 1\nBCOORD\n1\n0 nope\n",     # junk value
    ]
    for text in bad:
        with pytest.raises(ValueError):
            parse_cbf(text)
        with tempfile.NamedTemporaryFile("w", suffix=".cbf",
                                         delete=False) as f:
            f.write(text)
            path = f.name
        with pytest.raises(ValueError):
            parse_cbf_native(path)
