"""Suite runner: solve a set of LP instances, emit per-instance JSON.

Equivalent of the reference's `test_one_abip.m` + batch runner shell layer
(`scripts/bench-lp/run_all_abip.sh`): each instance produces a JSON record
with the schema of `analyze_abip.py:9-31` (status, ipm_iter, admm_iter,
pres, dres, gap, pobj, dobj, time).  Instances come from MPS files
(--mps DIR) or the built-in generators (--generated).

The device mode (--batched) stacks same-shape generated instances and
solves them as ONE vmapped XLA program instead of one process per
instance.

Usage::

    python -m benchmarks.run_suite --generated smoke:8 --eps 1e-6 -o results/
    python -m benchmarks.run_suite --mps /path/to/netlib -o results/
    python -m benchmarks.run_suite --generated smoke:64 --batched -o results/
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np
import jax



# Allow `python benchmarks/run_suite.py` as well as `python -m benchmarks.run_suite`.
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


def record(name, sol, wall):
    return {
        "name": name,
        "status": sol.status_name,
        "ipm_iter": int(sol.ipm_iters),
        "admm_iter": int(sol.admm_iters),
        "pres": float(sol.res_pri),
        "dres": float(sol.res_dual),
        "gap": float(sol.rel_gap),
        "pobj": float(sol.pobj),
        "dobj": float(sol.dobj),
        "time": wall,
    }


def _mps_name(path):
    name = os.path.basename(path)
    for ext in (".gz", ".mps"):
        if name.endswith(ext):
            name = name[: -len(ext)]
    return name


def _pool_ordered(paths, one, threads, outdir, sig_fn=None):
    """Run one(path) over paths with a thread pool; emit in input order.

    sig_fn(path) -> hashable shape signature (or None on parse failure)
    enables the device-route compile discipline: XLA compiles MUST
    happen on the main thread (a worker thread triggering a compile can
    segfault jaxlib), so the first path of each distinct signature is
    solved serially here and the pool runs only warm-cache solves.
    """
    from abip.parallel.host_pool import pool_map

    serial_first = []
    if sig_fn is not None and threads > 1:
        seen = set()
        for p in paths:
            sig = sig_fn(p)
            if sig is not None and sig not in seen:
                seen.add(sig)
                serial_first.append(p)

    recs = {}
    for p in serial_first:
        recs[p] = one(p)
    pooled = [p for p in paths if p not in recs]
    for p, res in zip(pooled, pool_map(one, pooled, threads)):
        recs[p] = res

    out = []
    for p in paths:        # emit in input order regardless of phase
        name, rec = recs[p]
        out.append(rec)
        _write(outdir, name, rec)
        print(json.dumps(rec))
    return out


def run_mps(paths, eps, outdir, crossover=False, threads=1, **overrides):
    """threads>1 solves suite instances concurrently (host_pool; suite
    wall-clock drops ~cores-fold on CPU, but per-instance times then
    include contention -- keep threads=1 for SGM-comparable timings."""
    from abip.io.presolve import solve_mps

    def one(path):
        name = _mps_name(path)
        t0 = time.perf_counter()
        try:
            sol, std = solve_mps(path, eps=eps, **overrides)
            rec = record(name, sol, time.perf_counter() - t0)
            if crossover and rec["status"].startswith("Solved"):
                # vertex polish + exact-basis certificate on the
                # standard form (the `crossover_by_copt.py` role)
                from abip.crossover import crossover as _xover

                cr = _xover(std.A.toarray(), std.b, std.c, sol.x_std)
                rec["crossover_optimal"] = bool(cr.optimal)
                rec["pobj_vertex"] = std.user_objective(cr.pobj)
        except Exception as e:  # noqa: BLE001 -- a bench run logs failures
            rec = {"name": name, "status": f"Error: {e}",
                   "time": time.perf_counter() - t0}
        return name, rec

    sig_fn = None
    if overrides.get("method") == "device":
        # shape signature = presolved (padded) standard form; this
        # re-parses each file once (the shape is unknowable without
        # presolve), acceptable host-side cost next to the solves.
        # --bucket makes shapes repeat, which is what makes the pool
        # phase worthwhile.
        from abip.io.mps import read_mps
        from abip.io.presolve import pad_standard, presolve_to_standard

        def sig_fn(p):
            try:
                std = presolve_to_standard(read_mps(p))
                if overrides.get("pad_bucket"):
                    std = pad_standard(std, overrides["pad_bucket"])
                return std.A.shape
            except Exception:  # noqa: BLE001 -- let one() log the failure
                return None

    return _pool_ordered(paths, one, threads, outdir, sig_fn)


def run_highs(paths, outdir):
    """Competitor driver: scipy linprog (HiGHS) on the same MPS files,
    emitting the same record schema -- the role `pdlp_solve.py` /
    `copt_solve_lp.py` play in the reference bench layer
    (`scripts/bench-lp/analyze.py:20-47` method registry)."""
    from scipy.optimize import linprog

    from abip.io.mps import read_mps

    out = []
    for path in paths:
        name = _mps_name(path)
        t0 = time.perf_counter()
        try:
            p = read_mps(path)
            A = p.A.tocsr()
            eq = p.row_lo == p.row_hi
            le = ~eq & np.isfinite(p.row_hi)
            ge = ~eq & np.isfinite(p.row_lo)
            import scipy.sparse as _sp

            A_ub = _sp.vstack([A[le], -A[ge]]) if (le.any() or ge.any()) \
                else None
            b_ub = np.concatenate([p.row_hi[le], -p.row_lo[ge]]) \
                if A_ub is not None else None
            sgn = -1.0 if p.maximize else 1.0
            res = linprog(
                sgn * p.c,
                A_eq=A[eq] if eq.any() else None,
                b_eq=p.row_hi[eq] if eq.any() else None,
                A_ub=A_ub, b_ub=b_ub,
                bounds=np.column_stack([p.lb, p.ub]), method="highs",
            )
            wall = time.perf_counter() - t0
            rec = {
                "name": name,
                "status": "Solved" if res.status == 0 else res.message,
                "ipm_iter": 0,
                "admm_iter": int(getattr(res, "nit", 0) or 0),
                "pres": 0.0, "dres": 0.0, "gap": 0.0,
                "pobj": sgn * res.fun + p.objcon if res.status == 0
                else float("nan"),
                "dobj": float("nan"),
                "time": wall,
            }
        except Exception as e:  # noqa: BLE001
            rec = {"name": name, "status": f"Error: {e}",
                   "time": time.perf_counter() - t0}
        out.append(rec)
        _write(outdir, name, rec)
        print(json.dumps(rec))
    return out


def _conic_device_solve(A, b, c, cones, eps, **overrides):
    """The ONE device-route conic configuration both suite runners use
    (tuned in tools/conic_bench.py; keep in sync there)."""
    import jax
    import jax.numpy as jnp

    from abip.parallel.batched_qcp import solve_qcp_device

    A = A.toarray() if hasattr(A, "toarray") else np.asarray(A)
    r = solve_qcp_device(
        jnp.asarray(A), jnp.asarray(b), jnp.asarray(c),
        cones=cones, eps=eps, precision="mixed",
        normalize=True, rho_y=1e-3, max_admm=1_000_000,
        solver="inverse", inner_crit_period=8, **overrides)
    jax.block_until_ready(r)
    return r


def _device_record(name, r, t0):
    from abip.settings import Status

    return {
        "name": name, "status": Status.name(int(r.status)),
        "ipm_iter": int(r.ipm_iters), "admm_iter": int(r.admm_iters),
        "pres": float(r.res_pri), "dres": float(r.res_dual),
        "gap": float(r.rel_gap), "pobj": float(r.pobj),
        "dobj": float(r.dobj), "time": time.perf_counter() - t0,
    }


def run_sedumi(paths, eps, outdir, threads=1, device=False, method="abip",
               **overrides):
    """Conic suite runner on SeDuMi .mat files -- the `test_cblib.m:60-76`
    analogue.  If the .mat carries a `pobj_star` oracle field (conic_mini
    instances), the record includes the absolute objective error.
    threads: see `run_mps`.

    device=True routes each instance through `solve_qcp_device` (whole
    solve as ONE jitted program, anchored mixed precision): one dispatch
    per solve releases the GIL for the full solve, so --threads scales
    on the host too (the host driver's sprint cadence serializes there;
    measured 2.4x the reference binary at W=4 on the dim-204 class)."""
    from abip.io.sedumi import solve_sedumi

    if device and method not in ("abip", "device"):
        raise ValueError(
            f"--device runs the ABIP device solver; it cannot be combined "
            f"with --method {method} (the records would be mislabeled)")

    def one_device(path):
        from abip.io.sedumi import _convert_mat_dict, _read_mat

        name = os.path.splitext(os.path.basename(path))[0]
        t0 = time.perf_counter()
        try:
            d = _read_mat(path)
            A, b, c, cones, _perm = _convert_mat_dict(d)
            r = _conic_device_solve(A, b, c, cones, eps, **overrides)
            rec = _device_record(name, r, t0)
            star = d.get("pobj_star")
            if star is not None and np.asarray(star).size:
                star = float(np.asarray(star).ravel()[0])
                rec["pobj_star"] = star
                rec["obj_err"] = abs(rec["pobj"] - star) / max(1.0, abs(star))
        except Exception as e:  # noqa: BLE001 -- a bench run logs failures
            rec = {"name": name, "status": f"Error: {e}",
                   "time": time.perf_counter() - t0}
        return name, rec

    def one(path):
        name = os.path.splitext(os.path.basename(path))[0]
        t0 = time.perf_counter()
        try:
            if method == "pdhg":
                # conic competitor column (the SCS role,
                # `test_cblib.m:66-69`)
                from abip.io.sedumi import (_convert_mat_dict,
                                                _read_mat)
                from abip.pdhg import solve_qcp_pdhg

                d = _read_mat(path)
                A, b, c, cones, _perm = _convert_mat_dict(d)
                A = A.toarray() if hasattr(A, "toarray") else np.asarray(A)
                sol = solve_qcp_pdhg(A, b, c, cones, eps=eps, **overrides)
                extra = {"pobj_star": d.get("pobj_star")}
            else:
                sol, extra = solve_sedumi(path, eps=eps,
                                          extra_fields=("pobj_star",),
                                          **overrides)
            rec = record(name, sol, time.perf_counter() - t0)
            star = extra.get("pobj_star")
            if star is not None and np.asarray(star).size:
                star = float(np.asarray(star).ravel()[0])
                rec["pobj_star"] = star
                rec["obj_err"] = abs(rec["pobj"] - star) / max(1.0, abs(star))
        except Exception as e:  # noqa: BLE001 -- a bench run logs failures
            rec = {"name": name, "status": f"Error: {e}",
                   "time": time.perf_counter() - t0}
        return name, rec

    sig_fn = None
    if device:
        one = one_device
        from abip.io.sedumi import _convert_mat_dict, _read_mat

        def sig_fn(p):
            try:
                A, _b, _c, cones, _ = _convert_mat_dict(_read_mat(p))
                return (A.shape, cones)
            except Exception:  # noqa: BLE001 -- let one() log the failure
                return None

    return _pool_ordered(paths, one, threads, outdir, sig_fn)


def run_cbf(paths, eps, outdir, threads=1, device=False, method="abip",
            **overrides):
    """Conic suite runner on native CBLIB .cbf files (the `test_cblib.m`
    protocol without the Mosek reader).  If the suite directory carries
    an `optima.json` sidecar ({name: objective in the instance's own
    sense}), records include the absolute objective error.

    device=True routes through `solve_qcp_device` (one jitted program
    per solve); see `run_sedumi` for the threading discipline."""
    from abip.io.cbf import read_cbf, solve_cbf

    if device and method not in ("abip", "device"):
        raise ValueError(
            f"--device runs the ABIP device solver; it cannot be combined "
            f"with --method {method} (the records would be mislabeled)")

    optima = {}
    if paths:
        side = os.path.join(os.path.dirname(paths[0]), "optima.json")
        if os.path.exists(side):
            with open(side) as f:
                optima = json.load(f)

    def _finish(rec, name, obj):
        rec["pobj"] = obj  # instance-sense objective (MAX stays MAX)
        star = optima.get(name)
        if star is not None:
            rec["pobj_star"] = float(star)
            rec["obj_err"] = abs(obj - star) / max(1.0, abs(star))
        return rec

    def one_device(path):
        name = os.path.splitext(os.path.basename(path))[0]
        t0 = time.perf_counter()
        try:
            emb = read_cbf(path)
            r = _conic_device_solve(emb.A, emb.b, emb.c, emb.cones, eps,
                                    **overrides)
            rec = _device_record(name, r, t0)
            rec = _finish(rec, name, emb.objective(float(r.pobj)))
        except Exception as e:  # noqa: BLE001 -- a bench run logs failures
            rec = {"name": name, "status": f"Error: {e}",
                   "time": time.perf_counter() - t0}
        return name, rec

    def one(path):
        name = os.path.splitext(os.path.basename(path))[0]
        t0 = time.perf_counter()
        try:
            if method == "pdhg":
                from abip.pdhg import solve_qcp_pdhg

                emb = read_cbf(path)
                sol = solve_qcp_pdhg(emb.A, emb.b, emb.c, emb.cones,
                                     eps=eps, **overrides)
                obj = emb.objective(float(sol.pobj))
            else:
                sol, _x, obj = solve_cbf(path, eps=eps, **overrides)
            rec = record(name, sol, time.perf_counter() - t0)
            rec = _finish(rec, name, obj)
        except Exception as e:  # noqa: BLE001 -- a bench run logs failures
            rec = {"name": name, "status": f"Error: {e}",
                   "time": time.perf_counter() - t0}
        return name, rec

    sig_fn = None
    if device:
        one = one_device

        def sig_fn(p):
            # structure-only signature: parses (natively for big files,
            # same dispatch as the solve path) but never assembles the
            # dense embedding
            from abip.io.cbf import embedding_signature, parse_cbf_auto

            try:
                return embedding_signature(parse_cbf_auto(p))
            except Exception:  # noqa: BLE001 -- let one() log the failure
                return None

    return _pool_ordered(paths, one, threads, outdir, sig_fn)


def run_mps_batched(paths, eps, outdir, precision="f64"):
    """Presolve every MPS file, pad to common shape, solve as ONE program."""
    import jax

    from abip.io.mps import read_mps
    from abip.io.presolve import presolve_to_standard
    from abip.parallel.batched import solve_lp_suite
    from abip.settings import Status

    probs, stds, names = [], [], []
    for path in paths:
        name = _mps_name(path)
        std = presolve_to_standard(read_mps(path))
        probs.append((std.A.toarray(), std.b, std.c))
        stds.append(std)
        names.append(name)
    t0 = time.perf_counter()
    out_raw = solve_lp_suite(probs, eps=eps, precision=precision)
    wall = time.perf_counter() - t0
    out = []
    for name, std, r in zip(names, stds, out_raw):
        rec = {
            "name": name,
            "status": Status.name(r["status"]),
            "admm_iter": r["admm_iters"],
            "pres": r["res_pri"], "gap": r["rel_gap"],
            "pobj": std.user_objective(r["pobj"]),
            "dobj": std.user_objective(r["dobj"]),
            "time": wall / len(names),
            "batch_wall": wall,
        }
        out.append(rec)
        _write(outdir, name, rec)
        print(json.dumps(rec))
    return out


def run_generated(spec, eps, outdir, batched=False, precision="f64",
                  **overrides):
    import jax.numpy as jnp

    try:
        from . import generate
    except ImportError:                 # script mode: repo root on sys.path
        from benchmarks import generate

    kind, _, count = spec.partition(":")
    count = int(count or 4)
    kind, _, size = kind.partition("@")        # e.g. pagerank@50000:2
    gen = {"smoke": generate.smoke_lp, "hilbert": generate.hilbert_lp,
           "pagerank": generate.pagerank_lp}[kind]
    label = f"{kind}@{size}" if size else kind
    if size:
        import functools

        # per-generator size parameter (smoke_lp sizes by n_rand, not n)
        size_param = {"smoke": "n_rand", "hilbert": "n", "pagerank": "n"}
        gen = functools.partial(gen, **{size_param[kind]: int(size)})
    if kind == "pagerank":
        # sparse scattered-sparsity family: CG path, no batching
        overrides = {"linsys": "cg", "adaptive": False, **overrides}
        if batched:
            raise SystemExit("pagerank instances are sparse (CG path); "
                             "--batched applies to dense families only")
    out = []

    if batched:
        import jax
        from abip.parallel.batched import solve_lp_batch

        data = [gen(seed=i) for i in range(count)]
        As = jnp.asarray(np.stack([d[0] for d in data]))
        bs = jnp.asarray(np.stack([d[1] for d in data]))
        cs = jnp.asarray(np.stack([d[2] for d in data]))
        # compile excluded from the timing: warm with a single-instance shape
        t0 = time.perf_counter()
        res = solve_lp_batch(As, bs, cs, eps=eps, precision=precision)
        jax.block_until_ready(res)
        wall = time.perf_counter() - t0
        from abip.settings import Status

        for i in range(count):
            rec = {
                "name": f"{label}-{i}",
                "status": Status.name(int(res.status[i])),
                "ipm_iter": int(res.ipm_iters[i]),
                "admm_iter": int(res.admm_iters[i]),
                "pres": float(res.res_pri[i]),
                "dres": float(res.res_dual[i]),
                "gap": float(res.rel_gap[i]),
                "pobj": float(res.pobj[i]),
                "dobj": float(res.dobj[i]),
                "time": wall / count,   # amortized batch time
                "batch_wall": wall,
            }
            out.append(rec)
            _write(outdir, rec["name"], rec)
            print(json.dumps(rec))
        return out

    from abip import solve_lp

    for i in range(count):
        A, b, c = gen(seed=i)
        name = f"{label}-{i}"
        t0 = time.perf_counter()
        sol = solve_lp(A, b, c, eps=eps, **overrides)
        rec = record(name, sol, time.perf_counter() - t0)
        out.append(rec)
        _write(outdir, name, rec)
        print(json.dumps(rec))
    return out


def _write(outdir, name, rec):
    from benchmarks.ml_sweep import _validate_solved

    _validate_solved(rec)
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, f"{name}.json"), "w") as f:
            json.dump(rec, f, indent=2)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mps", help="directory of .mps(.gz) files")
    ap.add_argument("--cbf",
                    help="directory of CBLIB .cbf files (native reader; "
                         "optional optima.json sidecar for oracle checks)")
    ap.add_argument("--sedumi",
                    help="directory of SeDuMi .mat conic instances")
    ap.add_argument("--generated", help="generator spec, e.g. smoke:8")
    ap.add_argument("--batched", action="store_true",
                    help="solve generated instances as one vmapped program")
    ap.add_argument("--device", action="store_true",
                    help="(--sedumi) whole-solve-per-program conic path "
                    "(solve_qcp_device); scales with --threads")
    ap.add_argument("--precision", default="f64", choices=["f64", "mixed"])
    ap.add_argument("--method", default="abip",
                    choices=["abip", "highs", "pdhg", "device"],
                    help="solver to run on --mps files (highs = scipy "
                         "linprog, pdhg = restarted PDHG; competitor "
                         "columns for analyze --compare; device = "
                         "whole-solve-per-program device_solve_lp, "
                         "scales with --threads). --sedumi/--cbf accept "
                         "pdhg too (conic PDHG, the SCS role)")
    ap.add_argument("--eps", type=float, default=1e-6)
    ap.add_argument("--bucket", type=int, default=0,
                    help="pad --mps instances to shape multiples of N so "
                         "similar sizes share one compiled program")
    ap.add_argument("--crossover", action="store_true",
                    help="polish solved --mps instances to a vertex with "
                         "an exact-basis certificate (crossover_by_copt "
                         "analogue)")
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("--threads", type=int, default=1,
                    help="solve suite instances concurrently with a host "
                         "thread pool (suite wall-clock drops ~cores-fold "
                         "on CPU; per-instance times then include "
                         "contention, so keep 1 for SGM comparisons)")
    ap.add_argument("-o", "--outdir", default=None)
    args = ap.parse_args(argv)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    if args.mps:
        paths = sorted(
            glob.glob(os.path.join(args.mps, "*.mps"))
            + glob.glob(os.path.join(args.mps, "*.mps.gz"))
        )
        if not paths:
            raise SystemExit(f"no .mps files under {args.mps}")
        if args.method == "highs":
            run_highs(paths, args.outdir)
        elif args.method == "pdhg":
            run_mps(paths, args.eps, args.outdir, method="pdhg",
                    crossover=args.crossover, pad_bucket=args.bucket,
                    threads=args.threads)
        elif args.method == "device" or args.device:
            # --bucket pads shapes so same-bucket instances share one
            # compiled whole-solve program
            run_mps(paths, args.eps, args.outdir, method="device",
                    crossover=args.crossover, pad_bucket=args.bucket,
                    threads=args.threads)
        elif args.batched:
            run_mps_batched(paths, args.eps, args.outdir,
                            precision=args.precision)
        else:
            run_mps(paths, args.eps, args.outdir,
                    crossover=args.crossover, pad_bucket=args.bucket,
                    threads=args.threads)
    elif args.sedumi:
        paths = sorted(glob.glob(os.path.join(args.sedumi, "*.mat")))
        if not paths:
            raise SystemExit(f"no .mat files under {args.sedumi}")
        run_sedumi(paths, args.eps, args.outdir, threads=args.threads,
                   device=args.device, method=args.method)
    elif args.cbf:
        paths = sorted(glob.glob(os.path.join(args.cbf, "*.cbf")))
        if not paths:
            raise SystemExit(f"no .cbf files under {args.cbf}")
        run_cbf(paths, args.eps, args.outdir, threads=args.threads,
                device=args.device, method=args.method)
    elif args.generated:
        run_generated(args.generated, args.eps, args.outdir,
                      batched=args.batched, precision=args.precision)
    else:
        ap.error("one of --mps / --sedumi / --cbf / --generated is required")


if __name__ == "__main__":
    main()
