"""Head-to-head parity: reference C solver vs abip on IDENTICAL LPs.

Exports generated instances in the binary format read by
tools/reference_baseline_driver.c (compiled with -DPARITY_MAIN), runs
both solvers at the same tolerance, and compares status / objective /
iteration counts.

Usage::

    # build the reference binary first (see reference_baseline_driver.c)
    python tools/parity_run.py --ref-bin /tmp/refbench/refparity --eps 1e-6
"""
from __future__ import annotations

import argparse
import json
import re
import struct
import subprocess
import sys
import tempfile

import numpy as np
import scipy.sparse as sp


def export_instance(path, A, b, c):
    A = sp.csc_matrix(A)
    m, n = A.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<3q", m, n, A.nnz))
        f.write(np.asarray(A.indptr, "<i8").tobytes())
        f.write(np.asarray(A.indices, "<i8").tobytes())
        f.write(np.asarray(A.data, "<f8").tobytes())
        f.write(np.asarray(b, "<f8").tobytes())
        f.write(np.asarray(c, "<f8").tobytes())


def _mps_instances(mps_dir):
    """Presolved standard forms of every .mps file in a directory -- the
    round-2 Netlib comparison path."""
    import glob
    import os

    from abip.io.mps import read_mps
    from abip.io.presolve import presolve_to_standard

    for path in sorted(glob.glob(os.path.join(mps_dir, "*.mps"))):
        std = presolve_to_standard(read_mps(path))
        name = os.path.splitext(os.path.basename(path))[0]
        yield name, std.A.toarray(), std.b, std.c


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ref-bin", required=True)
    ap.add_argument("--eps", type=float, default=1e-6)
    ap.add_argument("--count", type=int, default=5)
    ap.add_argument("--m", type=int, default=50)
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--mps", help="directory of .mps files instead of generated")
    ap.add_argument("--classes", action="store_true",
                    help="extended sweep: several shape classes x --count, "
                         "including infeasible/unbounded status classes")
    ap.add_argument("--pathological", action="store_true",
                    help="pathological sweep (what Netlib actually "
                         "stresses): degenerate optimal vertices, ~1e6 "
                         "scaling spread, near-rank-deficient rows")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ".")
    import abip
    from benchmarks.generate import (hilbert_lp, infeasible_lp, smoke_lp,
                                     unbounded_lp)

    if args.mps:
        gen = _mps_instances(args.mps)
    elif args.pathological:
        from benchmarks.generate import (degenerate_lp, illscaled_lp,
                                         near_rankdef_lp)

        def _patho():
            for s in range(args.count):
                yield (f"degen-{s}",
                       *degenerate_lp(m=30, n=120, basis_deficit=4,
                                      dual_ties=6, seed=s))
            for s in range(args.count):
                yield (f"illscaled-{s}",
                       *illscaled_lp(m=30, n=120, spread=1e6, seed=s))
            for s in range(args.count):
                yield (f"rankdef-{s}",
                       *near_rankdef_lp(m=30, n=120, dep_rows=3,
                                        perturb=1e-8, seed=s))

        gen = _patho()
    elif args.classes:
        def _classes():
            for s in range(args.count):
                yield (f"smoke-{s}",
                       *smoke_lp(m=30, n_rand=270, density=0.3, seed=s))
            for s in range(args.count):
                yield (f"wide-{s}",
                       *smoke_lp(m=20, n_rand=980, density=0.1, seed=s))
            for s in range(args.count):
                yield f"hilbert-{s}", *hilbert_lp(n=40, shift=0.5, seed=s)
            for s in range(args.count):
                yield f"infeas-{s}", *infeasible_lp(m=15, n=60, seed=s)
            for s in range(args.count):
                yield f"unbdd-{s}", *unbounded_lp(m=15, n=60, seed=s)

        gen = _classes()
    else:
        gen = ((str(seed), *smoke_lp(m=args.m, n_rand=args.n - args.m,
                                     density=0.3, seed=seed))
               for seed in range(args.count))

    rows = []
    for seed, A, b, c in gen:
        with tempfile.NamedTemporaryFile(suffix=".bin", delete=False) as f:
            export_instance(f.name, A, b, c)
            path = f.name
        raw = subprocess.run(
            [args.ref_bin, path, str(args.eps)],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[-1]
        # the C driver prints bare inf/nan (infeasible/unbounded exits)
        raw = re.sub(r"\b-inf\b", "-Infinity", raw)
        raw = re.sub(r"\binf\b", "Infinity", raw)
        raw = re.sub(r"\bnan\b", "NaN", raw)
        ref = json.loads(raw)
        ours = abip.solve_lp(A, b, c, eps=args.eps)
        ref_pobj = ref.get("pobj", float("nan"))
        # normalize the two solvers' status vocabularies for comparison
        def _kind(s):
            s = str(s).lower()
            for k in ("infeasible", "unbounded", "solved"):
                if k in s:
                    return k
            return s
        row = {
            "seed": seed,
            "ref_status": ref["status"], "our_status": ours.status_name,
            "status_match": _kind(ref["status"]) == _kind(ours.status_name),
            "ref_pobj": ref_pobj, "our_pobj": ours.pobj,
            "pobj_rel_diff": abs(ref_pobj - ours.pobj) / (1 + abs(ref_pobj)),
            "ref_admm": ref["admm"], "our_admm": ours.admm_iters,
            "admm_ratio": ours.admm_iters / max(1, ref["admm"]),
            "ref_ipm": ref["ipm"], "our_ipm": ours.ipm_iters,
        }
        rows.append(row)
        print(json.dumps(row))

    solved = [r for r in rows if "Solved" in str(r["ref_status"])]
    ratios = [r["admm_ratio"] for r in solved] or [float("nan")]
    diffs = [r["pobj_rel_diff"] for r in solved
             if r["pobj_rel_diff"] == r["pobj_rel_diff"]] or [float("nan")]
    mismatches = [r["seed"] for r in rows if not r["status_match"]]
    print(f"# admm-iteration ratio (ours/ref, solved): min {min(ratios):.2f} "
          f"median {sorted(ratios)[len(ratios)//2]:.2f} max {max(ratios):.2f}")
    print(f"# max pobj rel diff (solved): {max(diffs):.2e}")
    print(f"# status matches: {len(rows) - len(mismatches)}/{len(rows)}"
          + (f"  MISMATCHES: {mismatches}" if mismatches else ""))
    return rows


if __name__ == "__main__":
    main()
