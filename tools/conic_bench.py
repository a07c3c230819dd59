"""Conic throughput head-to-head: reference ABIP-QCP binary vs abip.

The LP-side benchmark (`bench.py`) has a measured reference rate
(`BASELINE_MEASURED.json`); this records the conic analogue on a family
of medium random cone programs (exact-complementary-pair construction,
`benchmarks/conic_mini.randcone`): aggregate ADMM iterations/second for

  * the stub-built reference ABIP-QCP driver (QDLDL backend, recipe in
    `tools/reference_qcp_driver_notes.md`) run per instance,
  * our host conic driver, serial and under the thread pool, and
  * the fully-on-device batched driver (`solve_qcp_batch`, anchored
    mixed precision) -- ONE program for the whole suite.

Parity context: iteration counts are identical between the two solvers
on this construction (BASELINE_MEASURED.json conic_parity_head_to_head),
so aggregate iterations/s is an apples-to-apples rate.

Usage::

    python tools/conic_bench.py --ref-bin /tmp/qcpbench/qcpref \
        --n 16 --eps 1e-6 -o benchmarks/results/r02_conic_throughput.json
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import re
import tempfile
import time

import numpy as np
import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools.parity_qcp import export_conic  # noqa: E402




def family(n_inst, seed0=7_000, scale=1, qp=False):
    """Mixed-cone instances: dim 204*scale, m = dim//3.

    scale=1 is the QDLDL-friendly tiny class (dim 204); scale=5 is the
    dim-1020 class where the dense-factor/MXU design point crosses over.
    qp=True adds a full-rank PSD quadratic term (randqcp exact oracle;
    requires the Q-aware reference build qcpref_q).

    Returns 7-tuples (name, A, b, c, cones, Q-or-None, pobj_star).
    """
    from abip import ConeSpec

    from benchmarks.conic_mini import randcone, randqcp

    cones = ConeSpec(soc=(25 * scale, 25 * scale), rsoc=(4 * scale,),
                     nonneg=150 * scale)
    m = cones.dim // 3
    out = []
    for i in range(n_inst):
        if qp:
            nm, A, b, c, Q, cn, star = randqcp(f"qp{i}", m, cones,
                                               seed0 + i)
            out.append((nm, A, b, c, cn, Q, star))
        else:
            nm, A, b, c, cn, star = randcone(f"cb{i}", m, cones, seed0 + i)
            out.append((nm, A, b, c, cn, None, star))
    return out, cones


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ref-bin", default="/tmp/qcpbench/qcpref")
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--eps", type=float, default=1e-6)
    ap.add_argument("--scale", type=int, default=1,
                    help="family size multiplier (dim = 204*scale)")
    ap.add_argument("--only-batched", action="store_true",
                    help="run only the reference column and the batched "
                         "device sections (skips host/device-serial/pool "
                         "modes -- the quick device capture)")
    ap.add_argument("--no-batched", action="store_true",
                    help="skip the batched device driver (its lockstep "
                    "whole-suite program targets an accelerator; on CPU "
                    "at large dims its compile+run dominates the artifact)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="run each timed section N times, record the "
                    "fastest (this VM has noisy CPU steal; best-of-N "
                    "gives each side its clean-run rate)")
    ap.add_argument("--cpu", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="force the CPU backend (default; --no-cpu "
                    "leaves the accelerator backend active)")
    ap.add_argument("--qp", action="store_true",
                    help="quadratic-objective family (full-rank PSD Q; "
                         "point --ref-bin at the Q-aware qcpref_q)")
    ap.add_argument("-o", "--out", default=None)
    args = ap.parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import abip
    from abip.parallel.batched_qcp import solve_qcp_batch
    from abip.parallel.host_pool import pool_map

    insts, cones = family(args.n, scale=args.scale, qp=args.qp)
    out = {"eps": args.eps, "n_instances": args.n,
           "shape": f"m={insts[0][1].shape[0]} n={insts[0][1].shape[1]}",
           "cones": repr(cones), "qp": bool(args.qp)}

    def best_of(run):
        """Fastest of --repeats runs: (iters, wall_sec, all_ok)."""
        best = None
        for _ in range(max(1, args.repeats)):
            r = run()
            if best is None or r[1] < best[1]:
                best = r
        return best

    # -- reference binary, per instance -----------------------------------
    name_star = {t[0]: t[6] for t in insts}
    if os.path.exists(args.ref_bin):
        def run_ref():
            it_ref = t_ref = 0.0
            statuses = []
            for name, A, b, c, cn, Q, _ in insts:
                with tempfile.NamedTemporaryFile(suffix=".bin",
                                                 delete=False) as f:
                    Qm = (np.diag(Q) if (Q is not None and Q.ndim == 1)
                          else Q)
                    export_conic(f.name, A, b, c, cn, Q=Qm)
                    path = f.name
                raw = subprocess.run(
                    [args.ref_bin, path, str(args.eps)],
                    capture_output=True,
                    text=True, check=True).stdout.strip().splitlines()[-1]
                # the C driver prints bare inf/nan on certificate exits
                raw = re.sub(r"\b-inf\b", "-Infinity", raw)
                raw = re.sub(r"\binf\b", "Infinity", raw)
                raw = re.sub(r"\bnan\b", "NaN", raw)
                r = json.loads(raw)
                os.unlink(path)
                it_ref += r["admm"]
                t_ref += r["time_sec"]
                statuses.append(r["status"])
                if args.qp:
                    # guard against the Q=0 reference build, which
                    # silently ignores the trailing Q block and solves
                    # the LP relaxation instead
                    star = name_star[name]
                    if abs(r["pobj"] - star) / (1 + abs(star)) > 1e-2:
                        raise SystemExit(
                            f"reference pobj {r['pobj']:.6g} is far from "
                            f"the exact QP optimum {star:.6g} on {name}: "
                            "--ref-bin is probably the Q=0 build; use "
                            "qcpref_q (reference_qcp_driver_notes.md)")
            return it_ref, t_ref, all(
                s.startswith("Solved") for s in statuses)

        it_ref, t_ref, ok = best_of(run_ref)
        out["reference"] = {
            "agg_iters_per_sec": round(it_ref / t_ref, 1),
            "total_admm": int(it_ref), "total_sec": round(t_ref, 4),
            "all_solved": ok,
        }
    else:
        out["reference"] = {"error": f"{args.ref_bin} not found "
                            "(build recipe: reference_qcp_driver_notes.md)"}

    # -- ours: host driver serial and pooled ------------------------------
    if args.only_batched:
        return _batched_sections(args, out, insts, cones, jnp, solve_qcp_batch)

    def solve_host(inst):
        name, A, b, c, cn, Q, _ = inst
        t0 = time.perf_counter()
        sol = abip.solve_qcp(A, b, c, cn, Q=Q, eps=args.eps)
        return sol.admm_iters, time.perf_counter() - t0, sol.status_name

    solve_host(insts[0])  # warm the jit cache off the clock

    def run_host_serial():
        t0 = time.perf_counter()
        rs = [solve_host(i) for i in insts]
        dt = time.perf_counter() - t0
        return (sum(r[0] for r in rs), dt,
                all(r[2].startswith("Solved") for r in rs))

    its, dt, ok = best_of(run_host_serial)
    out["host_serial"] = {
        "agg_iters_per_sec": round(its / dt, 1),
        "total_admm": int(its), "total_sec": round(dt, 4),
        "all_solved": ok,
    }

    def run_host_pool():
        t0 = time.perf_counter()
        rs = pool_map(solve_host, insts)
        dt = time.perf_counter() - t0
        return (sum(r[0] for r in rs), dt,
                all(r[2].startswith("Solved") for r in rs))

    its, dt, ok = best_of(run_host_pool)
    out["host_pool"] = {
        "workers": os.cpu_count(),
        "agg_iters_per_sec": round(its / dt, 1),
        "total_sec": round(dt, 4),
        "all_solved": ok,
    }

    # -- ours: single-instance device programs, serial + pooled -----------
    # one dispatch per solve (whole solve in one jitted program) releases
    # the GIL for the full solve, so the host pool actually scales --
    # unlike the host driver's sprint cadence (see solve_qcp_device)
    from abip.parallel.batched_qcp import solve_qcp_device

    dkw = dict(cones=cones, eps=args.eps, precision="mixed",
               normalize=True, rho_y=1e-3, max_admm=1_000_000,
               solver="inverse", inner_crit_period=8)

    def solve_device(inst):
        name, A, b, c, cn, Q, _ = inst
        r = solve_qcp_device(jnp.asarray(A), jnp.asarray(b),
                             jnp.asarray(c),
                             jnp.asarray(Q) if Q is not None else None,
                             **dkw)
        jax.block_until_ready(r)
        return int(r.admm_iters), int(r.status)

    solve_device(insts[0])  # warm the jit cache off the clock

    def run_device_serial():
        t0 = time.perf_counter()
        rs = [solve_device(i) for i in insts]
        dt = time.perf_counter() - t0
        return sum(r[0] for r in rs), dt, all(r[1] == 1 for r in rs)

    its, dt, ok = best_of(run_device_serial)
    out["device_serial"] = {
        "agg_iters_per_sec": round(its / dt, 1),
        "total_admm": int(its), "total_sec": round(dt, 4),
        "all_solved": ok,
    }
    insts_dp, _ = family(args.n, seed0=9_500, scale=args.scale, qp=args.qp)

    def run_device_pool():
        t0 = time.perf_counter()
        rs = pool_map(solve_device, insts_dp)
        dt = time.perf_counter() - t0
        return sum(r[0] for r in rs), dt, all(r[1] == 1 for r in rs)

    its, dt, ok = best_of(run_device_pool)
    out["device_pool"] = {
        "workers": os.cpu_count(),
        "agg_iters_per_sec": round(its / dt, 1),
        "total_admm": int(its), "total_sec": round(dt, 4),
        "all_solved": ok,
    }

    if args.no_batched:
        _finish(out, args)
        return out

    return _batched_sections(args, out, insts, cones, jnp, solve_qcp_batch)



def _ref_on_instances(ref_bin, eps, insts):
    """Serial reference wall/iters on EXACTLY these instances (the
    same-instance honest ratio -- fresh draws vary ~2-4x in difficulty,
    so a fixed-draw reference column under/over-states the ratio)."""
    if not os.path.exists(ref_bin):
        return None
    it_ref = t_ref = 0.0
    solved = 0
    for name, A, b, c, cn, Q, _ in insts:
        with tempfile.NamedTemporaryFile(suffix=".bin", delete=False) as f:
            Qm = (np.diag(Q) if (Q is not None and Q.ndim == 1) else Q)
            export_conic(f.name, A, b, c, cn, Q=Qm)
            path = f.name
        try:
            raw = subprocess.run(
                [ref_bin, path, str(eps)], capture_output=True,
                text=True, check=True).stdout.strip().splitlines()[-1]
            raw = re.sub(r"\b-inf\b", "-Infinity", raw)
            raw = re.sub(r"\binf\b", "Infinity", raw)
            raw = re.sub(r"\bnan\b", "NaN", raw)
            r = json.loads(raw)
        finally:
            os.unlink(path)
        it_ref += r["admm"]
        t_ref += r["time_sec"]
        solved += r["status"].startswith("Solved")
    return {"wall_sec": round(t_ref, 3), "total_admm": int(it_ref),
            "solved": solved}


def _upload(jnp, *arrays):
    """Move host arrays to the device and wait for the transfers BEFORE
    the caller starts a clock (`jnp.asarray` only dispatches them).  The
    reference column's time_sec likewise excludes instance loading
    (solver-internal timer), so pre-staging keeps the two columns
    symmetric."""
    out = jax.block_until_ready(
        tuple(None if a is None else jnp.asarray(a) for a in arrays))
    return out if len(out) > 1 else out[0]


def _batched_sections(args, out, insts, cones, jnp, solve_qcp_batch):
    """Batched device driver sections: steps (one program for the
    suite) and, for conic families, the two-phase sprint2 engine
    (fresh instances per round, median-of-rounds)."""
    import jax

    As, bs, cs, Qs = _upload(
        jnp, np.stack([t[1] for t in insts]),
        np.stack([t[2] for t in insts]),
        np.stack([t[3] for t in insts]),
        np.stack([t[5] for t in insts]) if args.qp else None)
    kw = dict(cones=cones, eps=args.eps, precision="mixed", normalize=True,
              rho_y=1e-3, max_admm=1_000_000, solver="inverse",
              inner_crit_period=8)
    rb = solve_qcp_batch(As, bs, cs, Qs, **kw)
    jax.block_until_ready(rb)          # compile + warm run off the clock
    insts2, _ = family(args.n, seed0=8_000,  # FRESH data for the timed run
                       scale=args.scale, qp=args.qp)
    As2, bs2, cs2, Qs2 = _upload(
        jnp, np.stack([t[1] for t in insts2]),
        np.stack([t[2] for t in insts2]),
        np.stack([t[3] for t in insts2]),
        np.stack([t[5] for t in insts2]) if args.qp else None)

    def run_batched():
        t0 = time.perf_counter()
        rb = solve_qcp_batch(As2, bs2, cs2, Qs2, **kw)
        jax.block_until_ready(rb)
        dt = time.perf_counter() - t0
        its = np.asarray(rb.admm_iters)
        return (int(its.sum()), dt,
                bool((np.asarray(rb.status) == 1).all()))

    its, dt, ok = run_batched()        # single fresh-data round
    out["batched_mixed"] = {
        "agg_iters_per_sec": round(its / dt, 1),
        "total_admm": its, "total_sec": round(dt, 4),
        "all_solved": ok,
    }

    # -- ours: batched sprint2 (fused conic DR kernel phase 1) ------------
    if not args.qp:
        kws = dict(kw, inner_crit_period=512, probe_period=8)
        eg = os.environ.get("ABIP_CONIC_ENDGAME")
        if eg:
            kws["endgame"] = eg
        rb = solve_qcp_batch(As, bs, cs, None, engine="sprint2", **kws)
        jax.block_until_ready(rb)      # compile/warm off the clock
        salt = (int(time.time()) % 1_000_000) * 100
        rounds = []
        for r_i in range(max(1, args.repeats)):
            fr, _ = family(args.n, seed0=salt + r_i * args.n,
                           scale=args.scale, qp=False)
            Af, bf, cf = _upload(jnp, np.stack([t[1] for t in fr]),
                                 np.stack([t[2] for t in fr]),
                                 np.stack([t[3] for t in fr]))
            t0 = time.perf_counter()
            rb = solve_qcp_batch(Af, bf, cf, None, engine="sprint2", **kws)
            jax.block_until_ready(rb)
            dt = time.perf_counter() - t0
            its = int(np.asarray(rb.admm_iters).sum())
            rounds.append((its / dt, its, dt,
                           bool((np.asarray(rb.status) == 1).all()), fr))
        rounds.sort(key=lambda r: r[0])
        med = rounds[(len(rounds) - 1) // 2]
        out["batched_sprint2"] = {
            "agg_iters_per_sec": round(med[0], 1),
            "total_admm": med[1], "total_sec": round(med[2], 4),
            "all_solved": med[3],
            "rounds": [{"rate": round(r[0], 1), "wall": round(r[2], 3),
                        "solved": r[3]} for r in rounds],
        }
        # honest same-instance head-to-head: the reference binary on the
        # MEDIAN round's exact draws (LP bench methodology)
        ref_same = _ref_on_instances(args.ref_bin, args.eps, med[4])
        if ref_same:
            out["batched_sprint2"].update(
                ref_same_instances=ref_same,
                wall_speedup_vs_ref_same=round(
                    ref_same["wall_sec"] / med[2], 2),
                iters_rate_vs_ref_same=round(
                    med[0] / (ref_same["total_admm"]
                              / max(ref_same["wall_sec"], 1e-9)), 2))

    _finish(out, args)
    return out


def _finish(out, args):
    ref_rate = out["reference"].get("agg_iters_per_sec")
    if ref_rate:
        for k, v in out.items():
            if isinstance(v, dict) and "agg_iters_per_sec" in v \
                    and k != "reference":
                v["vs_reference"] = round(
                    v["agg_iters_per_sec"] / ref_rate, 3)
    # reference-style per-iteration cost report (`source/linsys.c:71-97`
    # analogue): device-route single-instance roofline ceiling
    try:
        import jax

        from abip.utils.roofline import qcp_iteration_cost

        m, n = (int(s) for s in out["shape"].replace("m=", "")
                .replace("n=", "").split())
        kind = jax.devices()[0].device_kind
        c = qcp_iteration_cost(m, n, precision="mixed",
                               inner_crit_period=8, device_kind=kind)
        out["roofline"] = {
            "sol_iters_per_sec": round(c.ceiling_iters_per_sec, 1),
            "iter_bytes": int(c.bytes_moved),
            "device_kind": kind,
        }
    except KeyError:  # no published peaks for this device (e.g. the CPU)
        pass
    print(json.dumps(out, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
