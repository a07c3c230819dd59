"""Problem operators: the matrix-free abstraction of the constraint matrix.

JAX analogue of the reference's `spe_problem` vtable
(`/root/reference/src/abip-qcp/include/abip.h:29-60`): where the reference
stores C function pointers (`spe_A_times`, `spe_AT_times`, ...), we compose
jitted closures over jnp arrays.  Reformulated problems (LASSO/SVM) provide
operators that apply their constraint matrix without materializing it,
exactly like `lasso_A_times` (`source/lasso_config.c:99-110`) reuses the raw
data matrix twice.
"""
from __future__ import annotations

from typing import Callable, Optional

import jax.numpy as jnp


class LinearOperator:
    """A (possibly matrix-free) linear map R^n -> R^m.

    Attributes
    ----------
    matvec:  x (n,) -> A @ x (m,)
    rmatvec: y (m,) -> A.T @ y (n,)
    dense:   optional thunk returning the dense (m, n) matrix, used by the
             direct linsys backend and the equilibration pipeline.
    """

    def __init__(
        self,
        m: int,
        n: int,
        matvec: Callable,
        rmatvec: Callable,
        dense: Optional[Callable] = None,
        nnz: Optional[int] = None,
    ):
        self.m = int(m)
        self.n = int(n)
        self.matvec = matvec
        self.rmatvec = rmatvec
        self._dense = dense
        # nnz drives the sparsity-ratio heuristics of the barrier schedule
        # (`src/abip-lp/src/abip.c:2104-2115`); dense operators report full.
        self.nnz = int(nnz) if nnz is not None else m * n

    @property
    def has_dense(self) -> bool:
        return self._dense is not None

    def dense(self) -> jnp.ndarray:
        if self._dense is None:
            raise ValueError("operator has no dense representation")
        return self._dense()

    @property
    def sparsity(self) -> float:
        return self.nnz / max(1, self.m * self.n)

    @classmethod
    def from_dense(cls, A: jnp.ndarray, nnz: Optional[int] = None) -> "LinearOperator":
        A = jnp.asarray(A)
        m, n = A.shape
        return cls(
            m,
            n,
            matvec=lambda x: A @ x,
            rmatvec=lambda y: A.T @ y,
            dense=lambda: A,
            nnz=nnz,
        )

    @classmethod
    def from_scipy_sparse(cls, A, dtype=None,
                          layout: str = "auto") -> "LinearOperator":
        """Sparse operator backed by the `ops/` kernels.

        Both A and A^T are packed once at setup (the reference stores an
        explicit transpose too, `linsys/indirect.c:290-300`).  `layout`
        picks between (8,128)-tiled BCSR (block-structured sparsity, dense
        tile products) and padded-row ELL (scattered sparsity, gather+reduce); "auto"
        chooses ELL when BCSR tiles would be mostly padding.
        """
        import numpy as np
        import scipy.sparse as sp

        import jax.numpy as jnp_

        from .ops.ell import ELLMatrix, ell_matvec
        from .ops.bcsr import BCSRMatrix, bcsr_matvec

        dtype = dtype or jnp_.float64
        A = sp.csr_matrix(A)
        m, n = A.shape

        if layout == "auto":
            # estimated BCSR tile fill: nnz over the padded tile volume
            br = -(-m // 8)
            counts = np.diff(sp.csr_matrix(A).indptr)
            # upper bound on blocks/row-group: distinct 128-col tiles touched
            probe = min(br, 64)
            touched = 0
            for g in range(probe):
                rows = slice(g * 8, min((g + 1) * 8, m))
                idx = A[rows].indices // 128
                touched += len(np.unique(idx)) if len(idx) else 0
            est_tiles = touched / max(1, probe) * br
            fill = A.nnz / max(1.0, est_tiles * 8 * 128)
            layout = "bcsr" if fill > 0.05 else "ell"

        if layout == "ell":
            E = ELLMatrix.from_scipy(A, dtype=dtype)
            ET = ELLMatrix.from_scipy(A.T.tocsr(), dtype=dtype)
            op = cls(
                m, n,
                matvec=lambda x: ell_matvec(E, x),
                rmatvec=lambda y: ell_matvec(ET, y),
                nnz=int(A.nnz),
            )
            op.ell = E
            op.ell_T = ET
            sq = A.copy()
            sq.data = sq.data**2
            op.row_norms_sq = jnp_.asarray(np.asarray(sq.sum(axis=1)).ravel())
            op.col_norms_sq = jnp_.asarray(np.asarray(sq.sum(axis=0)).ravel())
            return op

        B = BCSRMatrix.from_scipy(A, dtype=dtype)
        BT = BCSRMatrix.from_scipy(A.T.tocsr(), dtype=dtype)

        op = cls(
            m,
            n,
            matvec=lambda x: bcsr_matvec(B, x),
            rmatvec=lambda y: bcsr_matvec(BT, y),
            nnz=int(A.nnz),
        )
        sq = A.copy()
        sq.data = sq.data**2
        op.row_norms_sq = jnp_.asarray(np.asarray(sq.sum(axis=1)).ravel())
        op.col_norms_sq = jnp_.asarray(np.asarray(sq.sum(axis=0)).ravel())
        op.bcsr = B
        op.bcsr_T = BT
        return op
