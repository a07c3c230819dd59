"""netlib-mini: a generated suite of Netlib-class general-form LPs.

The reference validates correctness by solving the public Netlib suite to
tolerance (`/root/reference/scripts/bench-lp/conf/netlib.json:4-38`,
`test_one_abip.m:29-37`).  Those files are not redistributable inside this
repo, so this module generates a stand-in suite with the same *structural*
variety -- equality/inequality rows, RANGES, finite/negative/free bounds,
maximize instances, afiro-class sizes -- from classic LP model families
(transportation, multi-period production, blending, set covering,
min-cost flow, resource-constrained revenue).

Every builder constructs the instance around a known feasible point, so
all instances are feasible; min instances have c >= 0 over x >= 0 (bounded
below), max instances have finite upper bounds (bounded above).

Usage::

    python -m benchmarks.netlib_mini -o suites/netlib_mini   # write .mps
    python -m benchmarks.run_suite --mps suites/netlib_mini --eps 1e-6
"""
from __future__ import annotations

import argparse
import os
from typing import Callable, Dict

import numpy as np
import scipy.sparse as sp

from abip.io.mps import GeneralLP


def _lp(c, A, row_lo, row_hi, lb, ub, name, maximize=False) -> GeneralLP:
    A = sp.csc_matrix(A)
    m, n = A.shape
    return GeneralLP(
        c=np.asarray(c, float), A=A,
        row_lo=np.asarray(row_lo, float), row_hi=np.asarray(row_hi, float),
        lb=np.asarray(lb, float), ub=np.asarray(ub, float),
        maximize=maximize, name=name,
        col_names=[f"X{j}" for j in range(n)],
        row_names=[f"R{i}" for i in range(m)],
    )


def transport(s: int, d: int, seed: int) -> GeneralLP:
    """Balanced transportation: min cost, supply/demand equalities."""
    rng = np.random.default_rng(seed)
    supply = rng.integers(10, 50, s).astype(float)
    # balanced demand
    total = supply.sum()
    w = rng.random(d)
    demand = np.floor(total * w / w.sum())
    demand[0] += total - demand.sum()
    n = s * d
    rows, cols, vals = [], [], []
    for i in range(s):
        for j in range(d):
            k = i * d + j
            rows += [i, s + j]
            cols += [k, k]
            vals += [1.0, 1.0]
    A = sp.coo_matrix((vals, (rows, cols)), shape=(s + d, n))
    b = np.concatenate([supply, demand])
    c = rng.uniform(1.0, 20.0, n)
    return _lp(c, A, b, b, np.zeros(n), np.full(n, np.inf),
               f"TRAN{s}X{d}")


def production(T: int, P: int, seed: int) -> GeneralLP:
    """Multi-period production with inventory balance and a free
    total-cost accounting column (exercises FR bounds)."""
    rng = np.random.default_rng(seed)
    cap = rng.uniform(8.0, 15.0, P)          # per-product per-period cap
    shared = 0.8 * cap.sum()                  # shared capacity per period
    dem = rng.uniform(2.0, 7.0, (T, P))
    # vars: x[t,p] production, v[t,p] inventory (>=0), z total cost (free)
    nx = T * P
    n = 2 * nx + 1
    ix = lambda t, p: t * P + p            # noqa: E731
    iv = lambda t, p: nx + t * P + p       # noqa: E731
    iz = 2 * nx
    prod_cost = rng.uniform(1.0, 5.0, (T, P))
    hold_cost = rng.uniform(0.1, 0.5, P)
    rows, cols, vals = [], [], []
    row_lo, row_hi = [], []
    r = 0
    # inventory balance: v[t] - v[t-1] - x[t] = -dem[t]   (E rows)
    for t in range(T):
        for p in range(P):
            rows += [r, r]
            cols += [iv(t, p), ix(t, p)]
            vals += [1.0, -1.0]
            if t > 0:
                rows.append(r)
                cols.append(iv(t - 1, p))
                vals.append(-1.0)
            row_lo.append(-dem[t, p])
            row_hi.append(-dem[t, p])
            r += 1
    # shared capacity: sum_p x[t,p] <= shared   (L rows)
    for t in range(T):
        for p in range(P):
            rows.append(r)
            cols.append(ix(t, p))
            vals.append(1.0)
        row_lo.append(-np.inf)
        row_hi.append(shared)
        r += 1
    # accounting: z - sum cost*x - sum hold*v = 0   (E row, z free)
    rows.append(r)
    cols.append(iz)
    vals.append(1.0)
    for t in range(T):
        for p in range(P):
            rows += [r, r]
            cols += [ix(t, p), iv(t, p)]
            vals += [-prod_cost[t, p], -hold_cost[p]]
    row_lo.append(0.0)
    row_hi.append(0.0)
    r += 1
    A = sp.coo_matrix((vals, (rows, cols)), shape=(r, n))
    c = np.zeros(n)
    c[iz] = 1.0
    lb = np.zeros(n)
    ub = np.full(n, np.inf)
    ub[:nx] = np.tile(cap, T)
    lb[iz], ub[iz] = -np.inf, np.inf      # free accounting column
    # feasible: produce exactly demand each period (x = dem <= cap, and
    # sum_p dem[t] < shared by construction margins)
    assert (dem <= cap).all() and (dem.sum(axis=1) <= shared).all()
    return _lp(c, A, row_lo, row_hi, lb, ub, f"PROD{T}X{P}")


def blend(ing: int, nutr: int, seed: int) -> GeneralLP:
    """Blending with ranged nutrient rows (exercises RANGES)."""
    rng = np.random.default_rng(seed)
    N = rng.uniform(0.0, 10.0, (nutr, ing))
    x0 = rng.random(ing)
    x0 /= x0.sum()                        # feasible mix on the simplex
    mid = N @ x0
    lo = mid * rng.uniform(0.7, 0.95, nutr)
    hi = mid * rng.uniform(1.05, 1.3, nutr)
    A = np.vstack([N, np.ones((1, ing))])
    row_lo = np.concatenate([lo, [1.0]])
    row_hi = np.concatenate([hi, [1.0]])
    c = rng.uniform(1.0, 30.0, ing)
    ub = np.clip(x0 * rng.uniform(1.5, 4.0, ing), 0.05, 1.0)
    return _lp(c, A, row_lo, row_hi, np.zeros(ing), ub,
               f"BLEND{ing}X{nutr}")


def cover(m: int, n: int, seed: int) -> GeneralLP:
    """LP relaxation of set covering: A in {0,1}, Ax >= 1, 0<=x<=1."""
    rng = np.random.default_rng(seed)
    A = (rng.random((m, n)) < max(3.0 / n, 0.05)).astype(float)
    # guarantee every row is coverable
    for i in np.nonzero(A.sum(axis=1) == 0)[0]:
        A[i, rng.integers(0, n)] = 1.0
    c = rng.uniform(1.0, 10.0, n)
    return _lp(c, sp.csc_matrix(A), np.ones(m), np.full(m, np.inf),
               np.zeros(n), np.ones(n), f"COVER{m}X{n}")


def flow(nodes: int, arcs: int, seed: int) -> GeneralLP:
    """Min-cost flow built around a feasible capacity-respecting flow."""
    rng = np.random.default_rng(seed)
    tail = rng.integers(0, nodes, arcs)
    head = (tail + rng.integers(1, nodes, arcs)) % nodes
    capv = rng.uniform(5.0, 20.0, arcs)
    x0 = rng.uniform(0.0, 1.0, arcs) * capv
    rows = np.concatenate([tail, head])
    cols = np.concatenate([np.arange(arcs), np.arange(arcs)])
    vals = np.concatenate([np.ones(arcs), -np.ones(arcs)])
    Ninc = sp.coo_matrix((vals, (rows, cols)), shape=(nodes, arcs))
    b = Ninc @ x0                          # feasible by construction
    c = rng.uniform(1.0, 15.0, arcs)
    return _lp(c, Ninc, b, b, np.zeros(arcs), capv,
               f"FLOW{nodes}X{arcs}")


def revenue(m: int, n: int, seed: int) -> GeneralLP:
    """Maximize revenue under resource limits (exercises OBJSENSE MAX)."""
    rng = np.random.default_rng(seed)
    U = rng.uniform(0.0, 3.0, (m, n)) * (rng.random((m, n)) < 0.3)
    x0 = rng.uniform(0.0, 2.0, n)
    limit = U @ x0 + rng.uniform(1.0, 5.0, m)
    c = rng.uniform(1.0, 12.0, n)
    ub = rng.uniform(2.0, 6.0, n)
    return _lp(c, sp.csc_matrix(U), np.full(m, -np.inf), limit,
               np.zeros(n), ub, f"REV{m}X{n}", maximize=True)


MANIFEST: Dict[str, Callable[[], GeneralLP]] = {
    "tran01": lambda: transport(8, 5, seed=11),
    "tran02": lambda: transport(20, 15, seed=12),
    "prod01": lambda: production(6, 4, seed=21),
    "prod02": lambda: production(12, 8, seed=22),
    "blend01": lambda: blend(8, 6, seed=31),
    "blend02": lambda: blend(24, 14, seed=32),
    "cover01": lambda: cover(40, 100, seed=41),
    "cover02": lambda: cover(80, 200, seed=42),
    "flow01": lambda: flow(30, 90, seed=51),
    "flow02": lambda: flow(60, 200, seed=52),
    "rev01": lambda: revenue(30, 60, seed=61),
    "rev02": lambda: revenue(60, 150, seed=62),
}


def write_suite(outdir: str) -> None:
    from abip.io.mps_write import write_mps

    os.makedirs(outdir, exist_ok=True)
    for name, build in MANIFEST.items():
        write_mps(build(), os.path.join(outdir, f"{name}.mps"),
                  name=name.upper())
        print(f"wrote {name}.mps")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-o", "--outdir", default="suites/netlib_mini")
    args = ap.parse_args(argv)
    write_suite(args.outdir)


if __name__ == "__main__":
    main()
