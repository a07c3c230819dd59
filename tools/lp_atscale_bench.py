"""At-scale batched LP: sprint2+delta vs the reference binary.

Runs the protocol at m=500 x n=5000 (density 0.1 by default) with the
delta endgame and uploads staged BEFORE the clock, symmetric with the
reference column's solver-internal time_sec
(`tools/reference_baseline_driver.c`).  Each round draws fresh
instances; the reference runs on the SAME draws as the best fully
solved round.

Usage::

    python tools/lp_atscale_bench.py --m 500 --n 5000 --count 8 \
        -o results/lp_m500.json
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools.parity_run import export_instance  # noqa: E402




def _ref_on(ref_bin, eps, insts):
    tot_admm, tot_sec, solved = 0, 0.0, 0
    for A, b, c in insts:
        with tempfile.NamedTemporaryFile(suffix=".bin", delete=False) as f:
            export_instance(f.name, A, b, c)
            path = f.name
        try:
            raw = subprocess.run(
                [ref_bin, path, str(eps)], capture_output=True,
                text=True, check=True).stdout.strip().splitlines()[-1]
            raw = re.sub(r"\b-?inf\b|\bnan\b", "0", raw)
            ref = json.loads(raw)
        finally:
            os.unlink(path)
        tot_admm += ref["admm"]
        tot_sec += ref["time_sec"]
        solved += "Solved" in str(ref["status"])
    return {"wall_sec": round(tot_sec, 3), "total_admm": int(tot_admm),
            "solved": solved}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ref-bin", default="/tmp/refbench/refparity")
    ap.add_argument("--m", type=int, default=500)
    ap.add_argument("--n", type=int, default=5000)
    ap.add_argument("--density", type=float, default=0.1)
    ap.add_argument("--count", type=int, default=8, help="batch size B")
    ap.add_argument("--eps", type=float, default=1e-6)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--engine", default="sprint2")
    ap.add_argument("--endgame", default="delta")
    ap.add_argument("--qres-period", type=int, default=1536)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("-o", "--out", default=None)
    args = ap.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from abip.parallel.batched import solve_lp_batch
    from benchmarks.generate import smoke_lp

    def batch(seed0):
        insts = [smoke_lp(m=args.m, n_rand=args.n - args.m,
                          density=args.density, seed=seed0 + s)
                 for s in range(args.count)]
        As = jnp.asarray(np.stack([t[0] for t in insts]))
        bs = jnp.asarray(np.stack([t[1] for t in insts]))
        cs = jnp.asarray(np.stack([t[2] for t in insts]))
        # force upload completion BEFORE any clock
        # (see tools/conic_bench._upload)
        jax.block_until_ready(jnp.sum(As) + jnp.sum(bs) + jnp.sum(cs))
        return As, bs, cs, insts

    kw = dict(eps=args.eps, max_ipm=200, max_admm=400_000,
              precision="mixed", solver="inverse",
              qres_period=args.qres_period, avg_period=20,
              engine=args.engine, endgame=args.endgame)

    out = {"purpose": f"at-scale LP, engine={args.engine}+"
                      f"{args.endgame}, B={args.count} m={args.m} "
                      f"n={args.n} d={args.density}",
           "eps": args.eps, "backend": jax.default_backend(),
           "rounds": []}

    As, bs, cs, _ = batch(31_000)
    r = solve_lp_batch(As, bs, cs, **kw)
    jax.block_until_ready(r)                                    # compile + warm
    salt = (int(time.time()) % 100_000) * 100
    best = None
    for i in range(args.rounds):
        As, bs, cs, insts = batch(salt + i * args.count)
        t0 = time.perf_counter()
        r = solve_lp_batch(As, bs, cs, **kw)
        jax.block_until_ready(r)
        dt = time.perf_counter() - t0
        its = np.asarray(r.admm_iters)
        st = np.asarray(r.status)
        rec = {"wall_sec": round(dt, 3), "solved": int((st == 1).sum()),
               "total_iters": int(its.sum()), "max_iters": int(its.max()),
               "iters_per_sec": round(its.sum() / dt, 1),
               "instances_per_sec": round(args.count / dt, 2)}
        out["rounds"].append(rec)
        if rec["solved"] == args.count and (
                best is None or dt < best[0]):
            best = (dt, rec, insts)
        print(json.dumps(rec), flush=True)

    if best is None:
        out["error"] = "no fully-solved round"
    else:
        dt, rec, insts = best
        out["best_solved_round"] = rec
        if os.path.exists(args.ref_bin):
            ref = _ref_on(args.ref_bin, args.eps, insts)
            out["ref_same_instances"] = ref
            out["wall_speedup_vs_ref_same"] = round(
                ref["wall_sec"] / dt, 2)
    print(json.dumps({k: v for k, v in out.items() if k != "rounds"},
                     indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
