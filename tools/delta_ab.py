"""End-to-end A/B of the delta engine: Triton kernel vs plain XLA.

Solves the bench's smoke batch (B=16, m=50, n=2000, eps=1e-6) with
`solve_lp_batch` in the HEADLINE configuration with the delta chunk as
the Triton kernel and as `_delta_ref` under XLA, in the order kernel,
xla, xla, kernel: each instance set is solved by both variants, each
run after its own warm-up.  Prints one JSON line per run plus a summary
with the card's name and power limit.  Needs a GPU.

    python tools/delta_ab.py [--rounds 2] [--B 16]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--B", type=int, default=16)
    args = ap.parse_args(argv)

    import jax

    if jax.devices()[0].platform != "gpu":
        print("delta_ab.py needs a GPU", file=sys.stderr)
        return 2
    import abip  # noqa: F401
    from abip.ops import admm_delta
    from abip.parallel import batched
    from bench import HEADLINE, smoke_batch

    kernel_on = admm_delta.use_kernel

    def run(variant, seed0):
        admm_delta.use_kernel = (kernel_on if variant == "kernel"
                                 else lambda m, n: False)
        batched._vmapped_solver.cache_clear()
        jax.clear_caches()
        jax.block_until_ready(batched.solve_lp_batch(
            *smoke_batch(10_000, args.B), **HEADLINE))
        insts = jax.block_until_ready(smoke_batch(seed0, args.B))
        t0 = time.perf_counter()
        r = jax.block_until_ready(batched.solve_lp_batch(*insts, **HEADLINE))
        wall = time.perf_counter() - t0
        its = np.asarray(r.admm_iters)
        rec = {"variant": variant, "seed0": seed0, "wall_sec": wall,
               "solved": int((np.asarray(r.status) == 1).sum()),
               "admm_total": int(its.sum()), "admm_max": int(its.max()),
               "iters_per_sec": float(its.sum() / wall)}
        print(json.dumps(rec), flush=True)
        return rec

    recs = []
    for i in range(args.rounds):
        # each instance set is solved by both variants
        for variant, seed0 in (("kernel", 2000 * i), ("xla", 2000 * i),
                               ("xla", 2000 * i + 1000),
                               ("kernel", 2000 * i + 1000)):
            recs.append(run(variant, seed0))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out = {"summary": "delta_ab", "device_kind": jax.devices()[0].device_kind,
           "nvidia_smi": smi}
    for v in ("kernel", "xla"):
        rs = [r for r in recs if r["variant"] == v]
        out[v] = {"median_wall_sec": float(np.median([r["wall_sec"]
                                                     for r in rs])),
                  "median_iters_per_sec": float(np.median(
                      [r["iters_per_sec"] for r in rs])),
                  "all_solved": all(r["solved"] == args.B for r in rs)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
