"""Merge the paper-protocol LASSO columns into one SGM-10 table.

Joins `lasso_m{m}_n{n}_ref.json` (reference C binary + ISTA oracle,
CPU) with `lasso_m{m}_n{n}.json` (our solver) by instance name and
emits the reference bench-layer aggregation: shifted geometric mean of
solve time, shift=10 s (`calculate_SGM.m:3`), plus per-instance status,
walls, iterations, and objective errors vs the ISTA oracle.

Usage::

    python -m benchmarks.ml_table \
        --ref benchmarks/results/r04_ml_lasso_paper_ref \
        --ours results/ml_lasso_paper_device \
        -o results/ml_lasso_paper_table.json
"""
from __future__ import annotations

import argparse
import json
import math
import os


def sgm10(times):
    return math.exp(sum(math.log(max(1.0, t + 10.0)) for t in times)
                    / len(times)) - 10.0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ref", required=True)
    ap.add_argument("--ours", required=True)
    ap.add_argument("--label", default="abip device route")
    ap.add_argument("-o", "--out", default=None)
    args = ap.parse_args(argv)

    rows = []
    for m in (1000, 2000, 5000):
        for n in (5000, 10000, 15000):
            name = f"lasso_m{m}_n{n}"
            rp = os.path.join(args.ref, name + "_ref.json")
            op = os.path.join(args.ours, name + ".json")
            if not os.path.exists(rp):
                continue
            ref = json.load(open(rp))
            row = {"name": name, "m": m, "n": n,
                   "ref_time": ref.get("ref_time"),
                   "ref_status": ref.get("ref_status"),
                   "ref_admm": ref.get("ref_admm"),
                   "ref_obj_err": ref.get("ref_obj_err"),
                   "obj_star": ref.get("obj_star")}
            if os.path.exists(op):
                ours = json.load(open(op))
                obj_err = None
                if row["obj_star"] is not None and "pobj" in ours:
                    obj_err = (abs(ours["pobj"] - row["obj_star"])
                               / max(1.0, abs(row["obj_star"])))
                row.update(our_time=ours.get("time"),
                           our_status=ours.get("status"),
                           our_admm=ours.get("admm_iter"),
                           our_obj_err=obj_err,
                           speedup=(ref.get("ref_time") / ours["time"]
                                    if ours.get("time") else None))
            rows.append(row)

    have_both = [r for r in rows if r.get("our_time")]
    table = {
        "protocol": "test_lasso.m:14-16,36-120 (m x n grid, eps=1e-3, "
                    "2000 s cap); SGM shift=10 (calculate_SGM.m:3)",
        "ours_label": args.label,
        "rows": rows,
        "sgm10_ref_sec": (round(sgm10([r["ref_time"] for r in rows
                                       if r.get("ref_time")]), 2)
                          if rows else None),
        "sgm10_ours_sec": (round(sgm10([r["our_time"]
                                        for r in have_both]), 2)
                           if have_both else None),
        "n_both": len(have_both),
    }
    if table["sgm10_ref_sec"] and table["sgm10_ours_sec"] \
            and len(have_both) == len(rows):
        table["sgm10_speedup"] = round(
            table["sgm10_ref_sec"] / table["sgm10_ours_sec"], 2)
    print(json.dumps(table, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(table, f, indent=1)
    return table


if __name__ == "__main__":
    main()
