"""A LASSO regularization-path sweep as ONE vmapped device program."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

if os.environ.get("ABIP_CPU", "1") != "0":  # CPU default; ABIP_CPU=0 for the GPU
    import jax

    jax.config.update("jax_platforms", "cpu")
import numpy as np

from abip.problems.lasso import solve_lasso_batch

rng = np.random.default_rng(2)
m, n, B = 40, 15, 6
X = rng.standard_normal((m, n))
w_true = np.zeros(n); w_true[:3] = [2.0, -1.0, 0.5]
y = X @ w_true + 0.05 * rng.standard_normal(m)

lams = np.geomspace(0.05, 2.0, B)
Xs = np.broadcast_to(X, (B, m, n))
ys = np.broadcast_to(y, (B, m))
W, objs, res = solve_lasso_batch(Xs, ys, lams, eps=1e-5)
for lam, w, obj in zip(lams, W, objs):
    nnz = int((np.abs(w) > 1e-4).sum())
    print(f"lambda={lam:6.3f}: obj={obj:8.4f} nnz={nnz}")
