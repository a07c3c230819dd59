"""Heterogeneous-cone batched throughput (`solve_qcp_het_batch`).

Solves the mixed 12-class conic-mini suite (different shapes AND cone
structures per lane) two ways on the active backend:

  * het_batch: ONE vmapped program, cone layout as lane data
    (`PaddedConeLayout.stack`), padded to common shapes;
  * device_route: the per-instance single-program route
    (`solve_qcp_device`) at each lane's natural shape, serial.

Both at eps, objectives checked against the suite's analytic optima
where available.  Medians over rounds of fresh seeds.

Usage::

    python tools/het_bench.py --rounds 3 -o results/het_batch.json
    python tools/het_bench.py --cpu            # CPU sanity run
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


def _suite(seed_shift=0):
    """The conic-mini mix with reseeded data (same shapes/cone mixes)."""
    from abip.cones import ConeSpec
    from benchmarks.conic_mini import nnlsq, portfolio, randcone

    return [
        randcone("rand_soc_a", 20, ConeSpec(soc=(8, 5, 3), nonneg=20),
                 11 + seed_shift),
        randcone("rand_soc_b", 35, ConeSpec(soc=(16, 9), free=4, nonneg=30),
                 12 + seed_shift),
        randcone("rand_rsoc_a", 25, ConeSpec(rsoc=(7, 5), nonneg=25),
                 13 + seed_shift),
        randcone("rand_rsoc_b", 30, ConeSpec(rsoc=(12,), free=3, nonneg=28),
                 14 + seed_shift),
        randcone("rand_mixed_a", 40,
                 ConeSpec(soc=(6, 4), rsoc=(5, 4), free=2, nonneg=32),
                 15 + seed_shift),
        randcone("rand_mixed_b", 55,
                 ConeSpec(soc=(10,), rsoc=(8,), free=5, nonneg=60),
                 16 + seed_shift),
        portfolio(24, 6, 21 + seed_shift),
        portfolio(40, 10, 22 + seed_shift),
        nnlsq(12, 30, 31 + seed_shift),
        nnlsq(20, 45, 32 + seed_shift),
        nnlsq(30, 25, 33 + seed_shift),
        randcone("rand_lp", 30, ConeSpec(nonneg=90), 17 + seed_shift),
    ]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--eps", type=float, default=1e-6)
    ap.add_argument("--rounds", type=int, default=3)
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

    from abip.parallel.batched_qcp import (solve_qcp_device,
                                               solve_qcp_het_batch)

    kw = dict(eps=args.eps, precision="mixed", rho_y=1e-3,
              max_admm=1_000_000, solver="inverse", inner_crit_period=8)

    def het_once(suite):
        probs = [(A, b, c, None, spec) for (_n, A, b, c, spec, _p) in suite]
        t0 = time.perf_counter()
        r = solve_qcp_het_batch(probs, normalize=True, **kw)
        jax.block_until_ready(r)
        dt = time.perf_counter() - t0
        its = int(np.asarray(r.admm_iters).sum())
        solved = int((np.asarray(r.status) == 1).sum())
        # objective check vs analytic optima where present
        max_err = 0.0
        for i, (_n, _A, _b, _c, _s, star) in enumerate(suite):
            if star is not None and int(r.status[i]) == 1:
                max_err = max(max_err, abs(float(r.pobj[i]) - star)
                              / (1 + abs(star)))
        return its, dt, solved, max_err

    def route_once(suite):
        t0 = time.perf_counter()
        its = 0
        solved = 0
        max_err = 0.0
        for (_n, A, b, c, spec, star) in suite:
            r = solve_qcp_device(jnp.asarray(A), jnp.asarray(b),
                                 jnp.asarray(c), None, cones=spec,
                                 normalize=True, **kw)
            jax.block_until_ready(r)
            its += int(r.admm_iters)
            solved += int(r.status) == 1
            if star is not None and int(r.status) == 1:
                max_err = max(max_err,
                              abs(float(r.pobj) - star) / (1 + abs(star)))
        return its, time.perf_counter() - t0, solved, max_err

    # warm both paths off the clock
    warm = _suite(0)
    het_once(warm)
    route_once(warm)

    salt = (int(time.time()) % 100_000) * 1000
    out = {"eps": args.eps, "suite": "conic-mini 12-class mix",
           "backend": jax.default_backend(), "rounds": []}
    for r_i in range(max(1, args.rounds)):
        suite = _suite(salt + 100 * r_i)
        h = het_once(suite)
        s = route_once(suite)
        out["rounds"].append({
            "het_batch": {"total_admm": h[0], "wall_sec": round(h[1], 4),
                          "solved": h[2], "max_obj_err": h[3],
                          "iters_per_sec": round(h[0] / h[1], 1)},
            "device_route": {"total_admm": s[0], "wall_sec": round(s[1], 4),
                             "solved": s[2], "max_obj_err": s[3],
                             "iters_per_sec": round(s[0] / s[1], 1)},
        })
        print(json.dumps(out["rounds"][-1]), flush=True)
    hw = sorted(r["het_batch"]["wall_sec"] for r in out["rounds"])
    sw = sorted(r["device_route"]["wall_sec"] for r in out["rounds"])
    med_h = hw[(len(hw) - 1) // 2]
    med_s = sw[(len(sw) - 1) // 2]
    out["median_het_wall_sec"] = med_h
    out["median_route_wall_sec"] = med_s
    out["het_speedup_vs_route"] = round(med_s / med_h, 2)
    print(json.dumps({k: v for k, v in out.items() if k != "rounds"},
                     indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
