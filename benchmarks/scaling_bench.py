"""Weak-scaling benchmark: batched instances over a growing device mesh.

Measures the M5 exit criterion of SURVEY.md section 7 (">=0.8 weak-scaling
efficiency ... on batched instances"): solve B0 instances per device on
1, 2, ..., N devices and report aggregate throughput + efficiency
relative to the single-device run.

On the virtual CPU mesh (JAX_PLATFORMS=cpu +
XLA_FLAGS=--xla_force_host_platform_device_count=8) it validates the
sharding methodology; the same script runs unchanged on several GPUs.

Usage::

    python -m benchmarks.scaling_bench --per-device 4 --devices 1 2 4 8 --cpu
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import jax




def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--per-device", type=int, default=4)
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--eps", type=float, default=1e-4)
    ap.add_argument("--m", type=int, default=20)
    ap.add_argument("--n", type=int, default=60)
    ap.add_argument("--precision", default="f64", choices=["f64", "mixed"])
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import abip  # noqa: F401
    from abip.parallel.batched import solve_lp_batch

    from .generate import smoke_lp

    def batch(B, seed0=0):
        data = [smoke_lp(m=args.m, n_rand=args.n - args.m, density=0.4,
                         seed=seed0 + i) for i in range(B)]
        return (jnp.asarray(np.stack([d[0] for d in data])),
                jnp.asarray(np.stack([d[1] for d in data])),
                jnp.asarray(np.stack([d[2] for d in data])))

    def batch_replicated(nd, seed0=0):
        """The SAME per-device instance set on every device: weak
        scaling then measures the PARALLEL overhead alone (ideal = flat
        wall), not the draw-to-draw iteration-count lottery that a
        fresh instance set per device count mixes in (the r04 0.737
        'dip' at 2 devices was that lottery: 2 extra instances with
        different difficulty entered the comparison)."""
        A1, b1, c1 = batch(args.per_device, seed0)
        return (jnp.tile(A1, (nd, 1, 1)), jnp.tile(b1, (nd, 1)),
                jnp.tile(c1, (nd, 1)))

    avail = jax.devices()
    results = []
    base_rate = None
    for nd in args.devices:
        if nd > len(avail):
            print(f"# skipping {nd} devices (only {len(avail)} available)")
            continue
        B = args.per_device * nd
        mesh = Mesh(np.array(avail[:nd]), ("batch",))
        kw = dict(eps=args.eps, precision=args.precision)
        # warm/compile on one dataset, then median-of-3 timed rounds
        # (single-round walls on a busy host carry CPU-steal noise)
        res = solve_lp_batch(*batch_replicated(nd, 10_000), mesh=mesh, **kw)
        jax.block_until_ready(res)
        walls = []
        for r_i in range(3):
            As, bs, cs = batch_replicated(nd, 100 * r_i)
            t0 = time.perf_counter()
            res = solve_lp_batch(As, bs, cs, mesh=mesh, **kw)
            jax.block_until_ready(res)
            walls.append(time.perf_counter() - t0)
        dt = sorted(walls)[len(walls) // 2]
        its = int(np.asarray(res.admm_iters).sum())
        solved = int((np.asarray(res.status) == 1).sum())
        rate = its / dt
        if base_rate is None:
            base_rate = rate / nd * 1  # per-device baseline at nd[0]
            base_nd = nd
        eff = (rate / nd) / (base_rate) if base_rate else float("nan")
        rec = {
            "devices": nd, "instances": B, "solved": solved,
            "total_admm_iters": its, "wall_sec": round(dt, 3),
            "agg_iters_per_sec": round(rate, 1),
            "weak_scaling_efficiency": round(eff, 3),
        }
        results.append(rec)
        print(json.dumps(rec))
    if results:
        final = results[-1]
        ok = final["weak_scaling_efficiency"] >= 0.8
        print(f"# weak-scaling efficiency at {final['devices']} devices: "
              f"{final['weak_scaling_efficiency']} ({'PASS' if ok else 'BELOW'} 0.8 target)")
    return results


if __name__ == "__main__":
    main()
