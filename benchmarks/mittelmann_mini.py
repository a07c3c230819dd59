"""mittelmann-mini: generated stand-ins for the Mittelmann LP set.

The reference's third LP suite is Hans Mittelmann's benchmark set
(`/root/reference/scripts/bench-lp/conf/mittelman.json`) -- larger,
harder instances than Netlib: multiperiod staircase structures, network
flows on big grids, and wide degenerate problems.  This module generates
those structures at the largest sizes this CPU environment solves in
seconds-to-minutes (m up to ~1500, n up to ~6000); the same builders
scale up by argument for accelerator runs.

Usage::

    python -m benchmarks.mittelmann_mini -o suites/mittelmann_mini
    python -m benchmarks.run_suite --mps suites/mittelmann_mini --eps 1e-6
"""
from __future__ import annotations

import argparse
import os
from typing import Callable, Dict

import numpy as np
import scipy.sparse as sp

from abip.io.mps import GeneralLP

from .netlib_mini import _lp


def staircase(periods: int, k: int, seed: int) -> GeneralLP:
    """Multiperiod production/inventory staircase: period blocks coupled
    by inventory carry-over -- the classic Mittelmann-style banded LP."""
    rng = np.random.default_rng(seed)
    # per period: k products, k resource rows + k inventory-balance rows
    n = periods * 2 * k                 # produce x_tp, store s_tp
    m = periods * 2 * k
    rows, cols, vals = [], [], []
    demand = rng.integers(5, 20, (periods, k)).astype(float)

    def xv(t, p):
        return t * 2 * k + p

    def sv(t, p):
        return t * 2 * k + k + p

    r = 0
    row_lo, row_hi = [], []
    for t in range(periods):
        # resource rows, caps set from the known feasible point
        # x = demand, s = 0 (30% slack) so the instance is feasible
        a = 1.0 + rng.random(k)
        for p in range(k):
            rows.append(r), cols.append(xv(t, p)), vals.append(a[p])
        row_lo.append(-np.inf), row_hi.append(1.3 * float(a @ demand[t]))
        r += 1
        grp = rng.integers(0, 2, k).astype(float) + 0.5
        for p in range(k):
            rows.append(r), cols.append(xv(t, p)), vals.append(grp[p])
        row_lo.append(-np.inf), row_hi.append(1.3 * float(grp @ demand[t]))
        r += 1
        # inventory balance per product: s_{t-1,p} + x_tp - s_tp = d_tp
        for p in range(k):
            if t > 0:
                rows.append(r), cols.append(sv(t - 1, p)), vals.append(1.0)
            rows.append(r), cols.append(xv(t, p)), vals.append(1.0)
            rows.append(r), cols.append(sv(t, p)), vals.append(-1.0)
            row_lo.append(demand[t, p]), row_hi.append(demand[t, p])
            r += 1
        # fill rows to keep m = periods*2k: one aggregate-inventory cap
        for _ in range(k - 2):
            p = rng.integers(0, k)
            rows.append(r), cols.append(sv(t, p)), vals.append(1.0)
            row_lo.append(-np.inf), row_hi.append(100.0)
            r += 1
    A = sp.csc_matrix((vals, (rows, cols)), shape=(r, n))
    # interleave produce/store costs to match xv/sv layout
    c = np.empty(n)
    for t in range(periods):
        c[t * 2 * k:t * 2 * k + k] = 1.0 + rng.random(k)
        c[t * 2 * k + k:(t + 1) * 2 * k] = 0.1 + 0.1 * rng.random(k)
    return _lp(c, A, row_lo, row_hi, np.zeros(n), np.full(n, np.inf),
               f"STAIR{seed}")


def grid_flow(g: int, seed: int) -> GeneralLP:
    """Min-cost flow on a g x g grid with one source/sink pair."""
    rng = np.random.default_rng(seed)
    nodes = g * g
    arcs = []
    for i in range(g):
        for j in range(g):
            u = i * g + j
            if j + 1 < g:
                arcs.append((u, u + 1))
            if i + 1 < g:
                arcs.append((u, u + g))
    n = len(arcs)
    rows, cols, vals = [], [], []
    for a, (u, v) in enumerate(arcs):
        rows += [u, v]
        cols += [a, a]
        vals += [1.0, -1.0]
    A = sp.csc_matrix((vals, (rows, cols)), shape=(nodes, n))
    supply = np.zeros(nodes)
    amt = float(rng.integers(20, 60))
    supply[0] = amt
    supply[-1] = -amt
    cost = 1.0 + rng.random(n) * 9.0
    cap = np.full(n, amt)
    return _lp(cost, A, supply, supply, np.zeros(n), cap, f"GRID{seed}")


def wide_degenerate(m: int, n: int, seed: int, density: float = 0.05) -> GeneralLP:
    """Wide standard-form LP with duplicated column blocks (degenerate
    optimal faces) at Mittelmann-ish aspect ratio."""
    rng = np.random.default_rng(seed)
    half = n // 2
    B = rng.standard_normal((m, half)) * (rng.random((m, half)) < density)
    # perturb only existing nonzeros: the twin block stays sparse
    A2 = B + 1e-7 * rng.standard_normal((m, half)) * (B != 0)
    A = np.concatenate([B, A2], axis=1)
    x0 = rng.random(n) + 0.5
    b = A @ x0
    c = A.T @ rng.standard_normal(m) + rng.random(n) + 0.5
    return _lp(c, A, b, b, np.zeros(n), np.full(n, np.inf),
               f"WIDE{seed}")


MANIFEST: Dict[str, Callable[[], GeneralLP]] = {
    "stair01": lambda: staircase(20, 10, seed=201),
    "stair02": lambda: staircase(40, 15, seed=202),
    "grid01": lambda: grid_flow(18, seed=211),
    "grid02": lambda: grid_flow(30, seed=212),
    "wide01": lambda: wide_degenerate(300, 3000, seed=221),
    "wide02": lambda: wide_degenerate(500, 6000, seed=222, density=0.03),
}


def write_suite(outdir: str) -> None:
    from abip.io.mps_write import write_mps

    os.makedirs(outdir, exist_ok=True)
    for name, build in MANIFEST.items():
        ext = ".mps.gz" if name.startswith("wide") else ".mps"
        write_mps(build(), os.path.join(outdir, f"{name}{ext}"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-o", "--outdir",
                    default="benchmarks/suites/mittelmann_mini")
    args = ap.parse_args(argv)
    write_suite(args.outdir)
    print(f"wrote {len(MANIFEST)} instances to {args.outdir}")


if __name__ == "__main__":
    main()
