"""Differentiating THROUGH the solver (the diffcp role).

Because the whole solver is JAX, the solution map (A, b, c) -> (x, y, s)
is exposed as a differentiable function (`abip.solve_lp_grad`,
implicit differentiation at the KKT system -- see abip/diff.py).
This example:

  1. checks the envelope theorem: d(c'x*)/db equals the dual y*
     (the LP's shadow prices), computed by jax.grad through a solve;
  2. computes the full sensitivity matrix dx*/db with jax.jacobian;
  3. runs a few steps of gradient descent ON THE PROBLEM DATA b
     (resource allocation) to cut the optimal cost under a quadratic
     adjustment penalty -- an optimization layer, LP inside.

Run: python examples/06_diff.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

if os.environ.get("ABIP_CPU", "1") != "0":  # CPU default; ABIP_CPU=0 for the GPU
    import jax

    jax.config.update("jax_platforms", "cpu")
import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")  # example runs anywhere

import jax.numpy as jnp  # noqa: E402

import abip  # noqa: E402

rng = np.random.default_rng(0)
m, n = 10, 30
A = jnp.asarray(rng.standard_normal((m, n)))
b0 = jnp.asarray(A @ (rng.random(n) + 0.5))
c = jnp.asarray(A.T @ rng.standard_normal(m) + rng.random(n) + 0.5)

# 1. shadow prices: grad of the optimal value w.r.t. the rhs is the dual
x, y, s = abip.solve_lp_grad(A, b0, c, eps=1e-9)
grad_b = jax.grad(lambda b: c @ abip.solve_lp_grad(A, b, c, eps=1e-9)[0])(b0)
print("envelope check  max|d(c'x)/db - y*| =",
      float(jnp.max(jnp.abs(grad_b - y))))

# 2. full solution sensitivity dx*/db (n x m), one jacobian call
J = jax.jacobian(lambda b: abip.solve_lp_grad(A, b, c, eps=1e-9)[0])(b0)
print("sensitivity dx*/db:", J.shape, " nonzero rows:",
      int(jnp.sum(jnp.any(jnp.abs(J) > 1e-9, axis=1))))

# 3. tune the resources: minimize optimal cost + adjustment penalty
def outer_loss(b):
    xstar = abip.solve_lp_grad(A, b, c, eps=1e-9)[0]
    return c @ xstar + 5.0 * jnp.sum((b - b0) ** 2)

loss_and_grad = jax.value_and_grad(outer_loss)
b = b0
for it in range(5):
    val, g = loss_and_grad(b)
    b = b - 0.02 * g
    print(f"outer step {it}: loss={float(val):.6f}  |grad|="
          f"{float(jnp.linalg.norm(g)):.4f}")
print("optimal cost moved", float(c @ x), "->",
      float(c @ abip.solve_lp_grad(A, b, c, eps=1e-9)[0]))
