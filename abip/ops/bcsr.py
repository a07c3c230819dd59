"""Block-sparse (BCSR) matrix-vector product in plain XLA.

Replacement for the reference's CSC SpMV kernels (`_accum_by_A` /
`_accum_by_Atrans`, `src/abip-lp/linsys/common.c:598-695`): scalar
gather/scatter loops become dense (BR, BC) tile products.  The host
packs a scipy sparse matrix into padded block rows once at setup
(`BCSRMatrix.from_scipy`); the product gathers each block row's x tiles
and contracts them in one einsum.  The row/column dims are zero-padded
up to tile multiples, so arbitrary shapes work.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

BR = 8     # block rows
BC = 128   # block cols


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class BCSRMatrix:
    """Padded block-compressed sparse rows.

    data:  (n_block_rows, max_blocks, BR, BC) tile values (zero-padded)
    cols:  (n_block_rows, max_blocks) int32 block-column ids (0 for pads;
           padded tiles are all-zero so they contribute nothing)
    shape: logical (m, n)
    """

    data: jnp.ndarray
    cols: jnp.ndarray
    shape: tuple
    nnz: int

    def tree_flatten(self):
        return (self.data, self.cols), (self.shape, self.nnz)

    @classmethod
    def tree_unflatten(cls, aux, children):
        data, cols = children
        shape, nnz = aux
        return cls(data=data, cols=cols, shape=shape, nnz=nnz)

    @property
    def padded_shape(self):
        return (self.data.shape[0] * BR, None)

    @classmethod
    def from_scipy(cls, A, dtype=jnp.float32) -> "BCSRMatrix":
        import scipy.sparse as sp

        A = sp.csr_matrix(A)
        m, n = A.shape
        nbr = -(-m // BR)
        nbc = -(-n // BC)
        m_pad, n_pad = nbr * BR, nbc * BC
        Ap = sp.csr_matrix((A.data, A.indices, A.indptr), shape=(m, n))
        Ap = sp.vstack([Ap, sp.csr_matrix((m_pad - m, n))]).tocsc()
        Ap = sp.hstack([Ap, sp.csc_matrix((m_pad, n_pad - n))]).tocsr()

        # find nonempty (block_row, block_col) tiles
        coo = Ap.tocoo()
        br = coo.row // BR
        bc = coo.col // BC
        tiles = {}
        for r, c, i, j, v in zip(br, bc, coo.row, coo.col, coo.data):
            key = (int(r), int(c))
            if key not in tiles:
                tiles[key] = np.zeros((BR, BC), np.float64)
            tiles[key][i - r * BR, j - c * BC] = v

        per_row = [[] for _ in range(nbr)]
        for (r, c), blk in sorted(tiles.items()):
            per_row[r].append((c, blk))
        max_blocks = max(1, max(len(row) for row in per_row))
        data = np.zeros((nbr, max_blocks, BR, BC), np.float64)
        cols = np.zeros((nbr, max_blocks), np.int32)
        for r, row in enumerate(per_row):
            for k, (c, blk) in enumerate(row):
                data[r, k] = blk
                cols[r, k] = c
        return cls(data=jnp.asarray(data, dtype), cols=jnp.asarray(cols),
                   shape=(m, n), nnz=int(A.nnz))

    @property
    def density_blocks(self) -> float:
        nbr, maxk = self.cols.shape
        return maxk / max(1, -(-self.shape[1] // BC))


@jax.jit
def bcsr_matvec(A: BCSRMatrix, x):
    """y = A @ x for a BCSRMatrix; returns the logical (m,) slice.

    Gathers the x tiles each block row touches and batches the tile
    products into one einsum."""
    m, n = A.shape
    n_pad = -(-n // BC) * BC
    x_pad = jnp.zeros((n_pad,), A.data.dtype).at[:n].set(
        x.astype(A.data.dtype))
    xs = x_pad.reshape(-1, BC)[A.cols]          # (nbr, maxk, BC)
    y = jnp.einsum("rkij,rkj->ri", A.data, xs).reshape(-1)
    return y[:m]
