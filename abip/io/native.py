"""ctypes bindings for the native C++ MPS parser (native/abip_io.cpp).

Builds on demand (`make -C native`) and falls back to the pure-Python
reader when the toolchain or library is unavailable, so the package stays
importable everywhere.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np
import scipy.sparse as sp

from .mps import GeneralLP

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libabip_io.so"))

_lib: Optional[ctypes.CDLL] = None


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", os.path.abspath(_NATIVE_DIR)],
                       check=True, capture_output=True, text=True)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH) and not _build():
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    # CBF symbols may be absent from a library built before
    # abip_cbf.cpp existed: rebuild once, and if the stale .so still
    # wins (build failure), keep the MPS surface working and mark the
    # CBF side unavailable instead of raising AttributeError.
    if not hasattr(lib, "abip_cbf_parse") and _build():
        lib = ctypes.CDLL(_LIB_PATH)
    _bind_mps(lib)
    _bind_cbf(lib)
    _lib = lib
    return lib


def _bind_mps(lib):
    f8 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i8 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.abip_mps_parse.restype = ctypes.c_void_p
    lib.abip_mps_parse.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                   ctypes.c_int64]
    lib.abip_mps_free.argtypes = [ctypes.c_void_p]
    lib.abip_mps_dims.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.abip_mps_data.argtypes = [ctypes.c_void_p, f8, f8, f8, f8, f8,
                                  i8, i8, f8]
    lib.abip_mps_row_names.restype = ctypes.c_int64
    lib.abip_mps_row_names.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_int64]
    lib.abip_mps_col_names.restype = ctypes.c_int64
    lib.abip_mps_col_names.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_int64]


def _bind_cbf(lib):
    if not hasattr(lib, "abip_cbf_parse"):
        return  # stale library: MPS keeps working, CBF side unavailable
    f8 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i8 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i4 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.abip_cbf_parse.restype = ctypes.c_void_p
    lib.abip_cbf_parse.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                   ctypes.c_int64]
    lib.abip_cbf_free.argtypes = [ctypes.c_void_p]
    lib.abip_cbf_dims.argtypes = (
        [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_int64)] * 9
        + [ctypes.POINTER(ctypes.c_double)])
    lib.abip_cbf_blocks.argtypes = [ctypes.c_void_p, i4, i8, i4, i8]
    lib.abip_cbf_data.argtypes = [ctypes.c_void_p, i8, i8, f8, i8, f8,
                                  i8, f8, i8]


def cbf_native_available() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "abip_cbf_parse")


def native_available() -> bool:
    return _load() is not None


def read_mps_native(path: str) -> GeneralLP:
    """Parse an MPS file with the C++ parser.  Raises if unavailable."""
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "native MPS parser not available (g++/make missing?); "
            "use abip.io.read_mps"
        )
    err = ctypes.create_string_buffer(1024)
    h = lib.abip_mps_parse(str(path).encode(), err, len(err))
    if not h:
        raise ValueError(err.value.decode())
    try:
        m = ctypes.c_int64()
        n = ctypes.c_int64()
        nnz = ctypes.c_int64()
        mx = ctypes.c_int32()
        objcon = ctypes.c_double()
        lib.abip_mps_dims(h, ctypes.byref(m), ctypes.byref(n),
                          ctypes.byref(nnz), ctypes.byref(mx),
                          ctypes.byref(objcon))
        m, n, nnz = m.value, n.value, nnz.value
        c = np.empty(n)
        row_lo = np.empty(m)
        row_hi = np.empty(m)
        lb = np.empty(n)
        ub = np.empty(n)
        Ap = np.empty(n + 1, np.int64)
        Ai = np.empty(max(nnz, 1), np.int64)
        Ax = np.empty(max(nnz, 1))
        lib.abip_mps_data(h, c, row_lo, row_hi, lb, ub, Ap, Ai, Ax)

        def names(fn):
            need = fn(h, None, 0)
            buf = ctypes.create_string_buffer(int(need))
            fn(h, buf, need)
            out = buf.value.decode().split("\n")
            return [s for s in out if s]

        row_names = names(lib.abip_mps_row_names)
        col_names = names(lib.abip_mps_col_names)
    finally:
        lib.abip_mps_free(h)

    A = sp.csc_matrix((Ax[:nnz], Ai[:nnz], Ap), shape=(m, n))
    return GeneralLP(
        c=c, A=A, row_lo=row_lo, row_hi=row_hi, lb=lb, ub=ub,
        objcon=objcon.value, maximize=bool(mx.value),
        name=os.path.basename(path),
        col_names=col_names, row_names=row_names,
    )


_CBF_CODES = {0: "F", 1: "L+", 2: "L-", 3: "L=", 4: "Q", 5: "QR"}


def parse_cbf_native(path: str):
    """Parse a .cbf file with the C++ parser -> `cbf.CBFProblem`.

    Same accepted grammar and rejections as the Python
    `cbf.parse_cbf`; duplicate OBJACOORD/BCOORD indices accumulate,
    matching the Python dict semantics.  Raises if unavailable.
    """
    from .cbf import CBFProblem

    lib = _load()
    if lib is None or not hasattr(lib, "abip_cbf_parse"):
        raise RuntimeError(
            "native CBF parser not available (g++/make missing, or a "
            "stale libabip_io.so); use abip.io.cbf.parse_cbf"
        )
    err = ctypes.create_string_buffer(1024)
    h = lib.abip_cbf_parse(str(path).encode(), err, len(err))
    if not h:
        raise ValueError(err.value.decode())
    try:
        n = ctypes.c_int64()
        m = ctypes.c_int64()
        nvb = ctypes.c_int64()
        ncb = ctypes.c_int64()
        nnz_a = ctypes.c_int64()
        nnz_o = ctypes.c_int64()
        nnz_b = ctypes.c_int64()
        n_int = ctypes.c_int64()
        sense = ctypes.c_int64()
        obj_b = ctypes.c_double()
        lib.abip_cbf_dims(h, n, m, nvb, ncb, nnz_a, nnz_o, nnz_b, n_int,
                          sense, obj_b)
        var_codes = np.zeros(nvb.value, np.int32)
        var_dims = np.zeros(nvb.value, np.int64)
        con_codes = np.zeros(ncb.value, np.int32)
        con_dims = np.zeros(ncb.value, np.int64)
        lib.abip_cbf_blocks(h, var_codes, var_dims, con_codes, con_dims)
        ai = np.zeros(nnz_a.value, np.int64)
        aj = np.zeros(nnz_a.value, np.int64)
        av = np.zeros(nnz_a.value, np.float64)
        oj = np.zeros(nnz_o.value, np.int64)
        ov = np.zeros(nnz_o.value, np.float64)
        bi = np.zeros(nnz_b.value, np.int64)
        bv = np.zeros(nnz_b.value, np.float64)
        ii = np.zeros(n_int.value, np.int64)
        lib.abip_cbf_data(h, ai, aj, av, oj, ov, bi, bv, ii)
    finally:
        lib.abip_cbf_free(h)

    obj_a: dict = {}
    for j, v in zip(oj.tolist(), ov.tolist()):
        obj_a[j] = obj_a.get(j, 0.0) + v
    b_coord: dict = {}
    for i, v in zip(bi.tolist(), bv.tolist()):
        b_coord[i] = b_coord.get(i, 0.0) + v
    return CBFProblem(
        objsense="MAX" if sense.value else "MIN",
        var_cones=[(_CBF_CODES[int(cd)], int(d))
                   for cd, d in zip(var_codes, var_dims)],
        con_cones=[(_CBF_CODES[int(cd)], int(d))
                   for cd, d in zip(con_codes, con_dims)],
        n=int(n.value), m=int(m.value), obj_a=obj_a,
        obj_b=float(obj_b.value),
        a_coord=list(zip(ai.tolist(), aj.tolist(), av.tolist())),
        b_coord=b_coord, integers=ii.tolist(),
    )
