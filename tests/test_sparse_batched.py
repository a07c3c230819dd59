"""Batched same-pattern sparse LP driver (`parallel/sparse_batched`).

Oracle: scipy linprog on dense copies (small shapes) and the exact
PageRank optimum 1'x* = 1 (`benchmarks.generate.pagerank_lp`)."""
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp


def _coo(A):
    Ac = sp.coo_matrix(A)
    order = np.lexsort((Ac.col, Ac.row))
    return Ac.row[order], Ac.col[order], Ac.data[order]


def test_sparse_batch_smoke_vs_scipy():
    from scipy.optimize import linprog

    from benchmarks.generate import smoke_lp
    from abip.parallel.sparse_batched import solve_lp_batch_coo

    A, b, c = smoke_lp(m=30, n_rand=80, density=0.3, seed=4)
    rows, cols, vals = _coo(A)
    r = solve_lp_batch_coo(rows, cols, jnp.asarray(vals[None]),
                           jnp.asarray(b[None]), jnp.asarray(c[None]),
                           m=A.shape[0], n=A.shape[1], eps=1e-6)
    ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, None), method="highs")
    assert int(r.status[0]) == 1
    assert abs(float(r.pobj[0]) - ref.fun) < 1e-4 * max(1, abs(ref.fun))


def test_sparse_batch_pagerank_family():
    """Same-pattern family (alpha sweep): every lane must hit the exact
    optimum 1'x* = 1 of the PageRank LP."""
    from benchmarks.generate import pagerank_lp
    from abip.parallel.sparse_batched import solve_lp_batch_coo

    n, B = 600, 3
    alphas = [0.80, 0.85, 0.90]
    valss, bs, cs = [], [], []
    rows = cols = None
    for a in alphas:
        A, b, c = pagerank_lp(n=n, deg=6, alpha=a, seed=100)
        r_, c_, v_ = _coo(A)
        if rows is None:
            rows, cols = r_, c_
        else:
            np.testing.assert_array_equal(rows, r_)   # shared pattern
        valss.append(v_)
        bs.append(b)
        cs.append(c)
    r = solve_lp_batch_coo(rows, cols, jnp.asarray(np.stack(valss)),
                           jnp.asarray(np.stack(bs)),
                           jnp.asarray(np.stack(cs)), m=n, n=n, eps=1e-6)
    st = np.asarray(r.status)
    po = np.asarray(r.pobj)
    assert (st == 1).all(), st
    assert np.abs(po - 1.0).max() < 1e-4, po
