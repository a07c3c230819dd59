"""Batched same-pattern PageRank LP family: device vs host driver.

A single instance through the host driver leaves nothing to amortize
per-stage dispatch against (19 barrier stages x ~5 iterations at
n=1e5).  This runs a same-pattern family (alpha sweep over one graph,
identical COO structure) with the ENTIRE solve on device
(`parallel/sparse_batched.solve_lp_batch_coo`) against the host driver
solving the same 8 instances serially (the reference regime: process-
level parallelism, `scripts/bench-lp/README.md:18-20`).

Usage::

    python tools/pagerank_batch_bench.py --n 100000 --B 8 \
        -o benchmarks/results/r05_pagerank_batch.json
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


def _family(n, B, seed=0):
    import scipy.sparse as sp

    from benchmarks.generate import pagerank_lp

    alphas = np.linspace(0.80, 0.87, B)
    rows = cols = None
    valss, bs, cs = [], [], []
    mats = []
    for a in alphas:
        A, b, c = pagerank_lp(n=n, deg=6, alpha=float(a), seed=seed)
        Ac = sp.coo_matrix(A)
        order = np.lexsort((Ac.col, Ac.row))
        if rows is None:
            rows, cols = Ac.row[order].astype(np.int32), \
                Ac.col[order].astype(np.int32)
        valss.append(Ac.data[order])
        bs.append(b)
        cs.append(c)
        mats.append((A, b, c))
    return rows, cols, np.stack(valss), np.stack(bs), np.stack(cs), mats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--B", type=int, default=8)
    ap.add_argument("--eps", type=float, default=1e-6)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--no-host", action="store_true",
                    help="skip the host-driver column")
    ap.add_argument("-o", "--out", default=None)
    args = ap.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from abip.parallel.sparse_batched import solve_lp_batch_coo

    out = {"purpose": "batched same-pattern sparse LP (pagerank alpha "
                      "family) fully on device vs 4-core host driver",
           "n": args.n, "B": args.B, "eps": args.eps,
           "backend": jax.default_backend(), "rounds": []}

    def upload(seed):
        rows, cols, valss, bs, cs, mats = _family(args.n, args.B, seed)
        rows_j = jnp.asarray(rows)
        cols_j = jnp.asarray(cols)
        vj, bj, cj = map(jnp.asarray, (valss, bs, cs))
        jax.block_until_ready(jnp.sum(vj) + jnp.sum(bj) + jnp.sum(cj)
             + jnp.sum(rows_j) + jnp.sum(cols_j))
        return rows_j, cols_j, vj, bj, cj, mats

    d = upload(0)
    r = solve_lp_batch_coo(*d[:5], m=args.n, n=args.n, eps=args.eps)
    jax.device_get((r.status, r.admm_iters, r.pobj))     # compile + warm
    salt = int(time.time()) % 10_000
    mats_last = None
    for i in range(args.rounds):
        d = upload(salt + i + 1)
        t0 = time.perf_counter()
        r = solve_lp_batch_coo(*d[:5], m=args.n, n=args.n, eps=args.eps)
        got = jax.device_get((r.status, r.admm_iters, r.pobj))
        dt = time.perf_counter() - t0
        st, its, po = map(np.asarray, got)
        rec = {"wall_sec": round(dt, 3), "solved": int((st == 1).sum()),
               "total_iters": int(its.sum()),
               "pobj_err_max": float(np.abs(po - 1.0).max())}
        out["rounds"].append(rec)
        mats_last = d[5]
        print(json.dumps(rec), flush=True)

    if not args.no_host and mats_last is not None:
        import abip

        t0 = time.perf_counter()
        solved = 0
        for (A, b, c) in mats_last:
            sol = abip.solve_lp(A, b, c, eps=args.eps)
            solved += sol.status_name.startswith("Solved")
        out["host_serial_same_instances"] = {
            "wall_sec": round(time.perf_counter() - t0, 3),
            "solved": solved,
            "note": "host driver (CG + sparse), serial over the SAME "
                    f"{args.B} instances on this host",
        }
        best = min(r["wall_sec"] for r in out["rounds"]
                   if r["solved"] == args.B)
        out["wall_speedup_vs_host"] = round(
            out["host_serial_same_instances"]["wall_sec"] / best, 2)
    print(json.dumps({k: v for k, v in out.items() if k != "rounds"},
                     indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
