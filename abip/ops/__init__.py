"""Operator kernels and layouts for the hot loops.

  * `bcsr`: block-sparse (BCSR) matrix-vector products, the replacement
    for the reference's CSC SpMV (`linsys/common.c:598-695`).
  * `ell`: ELLPACK sparse layout and its matvec.
  * `admm_delta`: the anchored-delta LP chunk -- a Triton kernel on the
    GPU, identical-math XLA elsewhere.
  * `admm_sprint` / `conic_sprint` / `conic_delta`: the f32 sprint and
    delta engines of the LP and conic batch drivers, in plain XLA.
"""
from .bcsr import BCSRMatrix, bcsr_matvec
from .admm_sprint import fused_admm_sprint

__all__ = ["BCSRMatrix", "bcsr_matvec", "fused_admm_sprint"]
