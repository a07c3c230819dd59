"""Wall breakdown for the conic sprint2+delta engine at dim-1020.

Splits the 3.35x capture (r04_conic_dim1020_delta.json) into
attributable parts so the remaining gap to the 5x bar can be engineered
away instead of guessed at:

  phase1      -- the fused-DR sprint call (engine="sprint", to mu switch)
  phase2      -- the anchored-delta endgame call (engine="delta", resume)
  p2_setup    -- the SAME phase-2 call with k_cap == entry iterations:
                 zero delta trips run, so this isolates per-call setup
                 (equilibration + factor chain + anchor build + final
                 residual pass) from the delta iterations themselves.
  p1_setup    -- phase-1 with k_cap=1 (one sprint chunk entry).

Usage::

    python tools/conic_delta_probe.py [--cpu] [--scale 5] [--n 16]
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
              inner_crit_period=args.T, probe_period=8, cadence="chunk")

    def batch(seed0):
        fr, cones = family(args.n, seed0=seed0, scale=args.scale)
        return (jnp.asarray(np.stack([t[1] for t in fr])),
                jnp.asarray(np.stack([t[2] for t in fr])),
                jnp.asarray(np.stack([t[3] for t in fr])), cones)

    def run_all(As, bs, cs, cones, timed):
        rec = {}

        def tcall(label, fn):
            t0 = time.perf_counter()
            r = fn()
            jax.block_until_ready(r)
            rec[label] = round(time.perf_counter() - t0, 4)
            return r

        r1 = tcall("phase1", lambda: _solve_qcp_batch_jit(
            As, bs, cs, None, cones=cones, engine="sprint",
            sprint_mu_switch=args.switch, mu_stop=args.switch, **kw))
        init = (r1.u_raw, r1.v_raw, r1.mu, r1.tol_inner, r1.admm_iters,
                r1.ipm_iters, r1.status)
        r2 = tcall("phase2", lambda: _solve_qcp_batch_jit(
            As, bs, cs, None, cones=cones, engine="delta",
            init_state=init, **kw))
        # setup proxies: zero (or one chunk of) iterations
        k_entry = np.int32(np.asarray(r1.admm_iters).max())
        tcall("p2_setup", lambda: _solve_qcp_batch_jit(
            As, bs, cs, None, cones=cones, engine="delta",
            init_state=init, k_cap=k_entry, **kw))
        tcall("p1_setup", lambda: _solve_qcp_batch_jit(
            As, bs, cs, None, cones=cones, engine="sprint",
            sprint_mu_switch=args.switch, mu_stop=args.switch,
            k_cap=np.int32(1), **kw))
        if timed:
            rec["iters_p1"] = np.asarray(r1.admm_iters).astype(int).tolist()
            rec["iters_total"] = np.asarray(
                r2.admm_iters).astype(int).tolist()
            rec["solved"] = int((np.asarray(r2.status) == 1).sum())
        return rec

    # warm all programs off the clock
    As, bs, cs, cones = batch(4242)
    run_all(As, bs, cs, cones, timed=False)

    salt = (int(time.time()) % 100_000) * 100
    As, bs, cs, cones = batch(salt)
    rec = run_all(As, bs, cs, cones, timed=True)
    rec["shape"] = f"m={As.shape[1]} n={As.shape[2]} B={As.shape[0]}"
    rec["backend"] = jax.default_backend()
    print(json.dumps(rec, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
