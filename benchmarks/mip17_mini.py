"""mip17-mini: generated MIPLIB-2017-relaxation-style LPs.

The reference's second LP suite is LP relaxations of MIPLIB-2017
integer programs (`/root/reference/scripts/bench-lp/conf/mip17.json`).
The defining structure is combinatorial: sparse 0/1 (or small-integer)
constraint matrices from covering/packing/assignment/knapsack models,
with box-bounded variables whose integrality is dropped.  This module
generates that structure from classic IP families; like netlib_mini,
every instance is built around a known feasible point.

Usage::

    python -m benchmarks.mip17_mini -o suites/mip17_mini
    python -m benchmarks.run_suite --mps suites/mip17_mini --eps 1e-6
"""
from __future__ import annotations

import argparse
import os
from typing import Callable, Dict

import numpy as np
import scipy.sparse as sp

from abip.io.mps import GeneralLP

from .netlib_mini import _lp


def set_packing(m: int, n: int, seed: int) -> GeneralLP:
    """max 1'x s.t. Ax <= 1, 0 <= x <= 1, A 0/1 sparse (LP relaxation)."""
    rng = np.random.default_rng(seed)
    A = (rng.random((m, n)) < 3.0 / m).astype(float)
    A[rng.integers(0, m, n), np.arange(n)] = 1.0   # no empty columns
    c = 1.0 + rng.random(n)
    return _lp(c, A, np.full(m, -np.inf), np.ones(m),
               np.zeros(n), np.ones(n), f"PACK{seed}", maximize=True)


def multi_knapsack(m: int, n: int, seed: int) -> GeneralLP:
    """max v'x s.t. Wx <= cap, 0 <= x <= 1; W small integers."""
    rng = np.random.default_rng(seed)
    W = rng.integers(0, 8, (m, n)).astype(float)
    cap = 0.4 * W.sum(axis=1)
    v = rng.integers(1, 20, n).astype(float)
    return _lp(v, W, np.full(m, -np.inf), cap,
               np.zeros(n), np.ones(n), f"MKNAP{seed}", maximize=True)


def assignment(k: int, seed: int) -> GeneralLP:
    """Relaxed assignment: doubly-stochastic equalities, min cost."""
    rng = np.random.default_rng(seed)
    n = k * k
    rows, cols = [], []
    for i in range(k):
        for j in range(k):
            rows += [i, k + j]
            cols += [i * k + j] * 2
    A = sp.csc_matrix((np.ones(2 * n), (rows, cols)), shape=(2 * k, n))
    c = rng.integers(1, 50, n).astype(float)
    one = np.ones(2 * k)
    return _lp(c, A, one, one, np.zeros(n), np.ones(n), f"ASSIGN{seed}")


def facility(f: int, cst: int, seed: int) -> GeneralLP:
    """Uncapacitated facility location relaxation:
    min sum f_i y_i + sum c_ij x_ij
    s.t. sum_i x_ij = 1 (each customer served), x_ij <= y_i, 0<=x,y<=1."""
    rng = np.random.default_rng(seed)
    n = f * cst + f                     # x_ij then y_i
    rows, cols, vals = [], [], []
    r = 0
    for j in range(cst):                # serve each customer
        for i in range(f):
            rows.append(r), cols.append(i * cst + j), vals.append(1.0)
        r += 1
    for i in range(f):                  # x_ij - y_i <= 0
        for j in range(cst):
            rows += [r, r]
            cols += [i * cst + j, f * cst + i]
            vals += [1.0, -1.0]
            r += 1
    A = sp.csc_matrix((vals, (rows, cols)), shape=(r, n))
    row_lo = np.concatenate([np.ones(cst), np.full(f * cst, -np.inf)])
    row_hi = np.concatenate([np.ones(cst), np.zeros(f * cst)])
    c = np.concatenate([rng.integers(1, 30, f * cst).astype(float),
                        rng.integers(20, 100, f).astype(float)])
    return _lp(c, A, row_lo, row_hi, np.zeros(n), np.ones(n),
               f"FACLOC{seed}")


def cutting_stock(m: int, n: int, seed: int) -> GeneralLP:
    """Cutting-stock-style covering: min 1'x s.t. Ax >= d, x >= 0,
    A small-integer pattern matrix."""
    rng = np.random.default_rng(seed)
    A = rng.integers(0, 4, (m, n)).astype(float)
    A[np.arange(m), rng.integers(0, n, m)] += 1.0   # coverable rows
    d = rng.integers(5, 40, m).astype(float)
    c = 1.0 + 0.1 * rng.random(n)
    return _lp(c, A, d, np.full(m, np.inf),
               np.zeros(n), np.full(n, np.inf), f"CSTOCK{seed}")


MANIFEST: Dict[str, Callable[[], GeneralLP]] = {
    "pack01": lambda: set_packing(60, 150, seed=71),
    "pack02": lambda: set_packing(150, 400, seed=72),
    "mknap01": lambda: multi_knapsack(15, 120, seed=81),
    "mknap02": lambda: multi_knapsack(40, 350, seed=82),
    "assign01": lambda: assignment(10, seed=91),
    "assign02": lambda: assignment(18, seed=92),
    "facloc01": lambda: facility(8, 25, seed=101),
    "facloc02": lambda: facility(15, 50, seed=102),
    "cstock01": lambda: cutting_stock(30, 80, seed=111),
    "cstock02": lambda: cutting_stock(70, 220, seed=112),
}


def write_suite(outdir: str) -> None:
    from abip.io.mps_write import write_mps

    os.makedirs(outdir, exist_ok=True)
    for name, build in MANIFEST.items():
        write_mps(build(), os.path.join(outdir, f"{name}.mps"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-o", "--outdir", default="benchmarks/suites/mip17_mini")
    args = ap.parse_args(argv)
    write_suite(args.outdir)
    print(f"wrote {len(MANIFEST)} instances to {args.outdir}")


if __name__ == "__main__":
    main()
