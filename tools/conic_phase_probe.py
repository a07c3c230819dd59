"""Phase-split wall breakdown for the conic sprint2 engine (dim-1020).

Times, on one fresh batch: phase-1 (fused-kernel stages to the mu
switch), phase-2 (anchored steps endgame resumed from phase-1 state),
and the plain steps engine end-to-end -- all with per-phase iteration
counts, so the sprint2 overhead (1.6x vs the 5x target at dim-1020,
r04_conic_sprint2_dim1020.json) can be attributed.

Usage::

    python tools/conic_phase_probe.py [--cpu] [--scale 5] [--n 16]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import jax



sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scale", type=int, default=5)
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--eps", type=float, default=1e-6)
    ap.add_argument("--switch", type=float, default=1e-3)
    ap.add_argument("--T", type=int, default=512)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("-o", "--out", default=None)
    args = ap.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if os.environ.get("ABIP_COMPILE_CACHE"):
        jax.config.update("jax_compilation_cache_dir",
                          os.environ["ABIP_COMPILE_CACHE"])
    import jax.numpy as jnp

    from tools.conic_bench import family
    from abip.parallel.batched_qcp import _solve_qcp_batch_jit

    kw = dict(eps=args.eps, precision="mixed", normalize=True, rho_y=1e-3,
              max_admm=1_000_000, solver="inverse",
              inner_crit_period=args.T, probe_period=8)

    def batch(seed0):
        fr, cones = family(args.n, seed0=seed0, scale=args.scale)
        return (jnp.asarray(np.stack([t[1] for t in fr])),
                jnp.asarray(np.stack([t[2] for t in fr])),
                jnp.asarray(np.stack([t[3] for t in fr])), cones)

    # warm all three programs
    As, bs, cs, cones = batch(4242)
    r1 = _solve_qcp_batch_jit(As, bs, cs, None, cones=cones,
                              engine="sprint", sprint_mu_switch=args.switch,
                              mu_stop=args.switch, **kw)
    jax.block_until_ready(r1)
    init = (r1.u_raw, r1.v_raw, r1.mu, r1.tol_inner, r1.admm_iters,
            r1.ipm_iters, r1.status)
    r2 = _solve_qcp_batch_jit(As, bs, cs, None, cones=cones,
                              engine="steps", init_state=init, **kw)
    jax.block_until_ready(r2)
    rs = _solve_qcp_batch_jit(As, bs, cs, None, cones=cones,
                              engine="steps", **kw)
    jax.block_until_ready(rs)

    salt = (int(time.time()) % 100_000) * 100
    As, bs, cs, cones = batch(salt)

    t0 = time.perf_counter()
    r1 = _solve_qcp_batch_jit(As, bs, cs, None, cones=cones,
                              engine="sprint", sprint_mu_switch=args.switch,
                              mu_stop=args.switch, **kw)
    jax.block_until_ready(r1)
    t1 = time.perf_counter()
    init = (r1.u_raw, r1.v_raw, r1.mu, r1.tol_inner, r1.admm_iters,
            r1.ipm_iters, r1.status)
    r2 = _solve_qcp_batch_jit(As, bs, cs, None, cones=cones,
                              engine="steps", init_state=init, **kw)
    jax.block_until_ready(r2)
    t2 = time.perf_counter()
    rs = _solve_qcp_batch_jit(As, bs, cs, None, cones=cones,
                              engine="steps", **kw)
    jax.block_until_ready(rs)
    t3 = time.perf_counter()

    it1 = np.asarray(r1.admm_iters)
    it2 = np.asarray(r2.admm_iters)
    its = np.asarray(rs.admm_iters)
    out = {
        "shape": f"m={As.shape[1]} n={As.shape[2]} B={As.shape[0]}",
        "switch": args.switch, "T": args.T,
        "backend": jax.default_backend(),
        "phase1": {"wall": round(t1 - t0, 3),
                   "iters": it1.astype(int).tolist(),
                   "ipm": np.asarray(r1.ipm_iters).astype(int).tolist(),
                   "mu": [float(f"{x:.2e}") for x in np.asarray(r1.mu)]},
        "phase2": {"wall": round(t2 - t1, 3),
                   "extra_iters": (it2 - it1).astype(int).tolist(),
                   "solved": int((np.asarray(r2.status) == 1).sum())},
        "steps_fresh": {"wall": round(t3 - t2, 3),
                        "iters": its.astype(int).tolist(),
                        "solved": int((np.asarray(rs.status) == 1).sum())},
    }
    print(json.dumps(out, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
