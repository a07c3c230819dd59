"""conic-mini: a generated suite of CBLIB-class conic instances.

The reference validates the conic solver on CBLIB problems loaded from
SeDuMi-format .mat structs (`scripts/bench-qcp/test_cblib.m:60-76`,
`get_abip_data_from_mosek.m`) at eps=1e-4.  CBLIB data is not
redistributable inside this repo, so this module generates a stand-in
suite with the same cone variety (SOC, rotated SOC, free, nonneg, mixed)
and writes it in the same SeDuMi .mat format so the full
loader -> permute -> solve -> un-permute pipeline is exercised.

Three instance families:

* ``randcone``: random (A, b, c) built around a KNOWN complementary
  primal-dual pair -- each cone block gets boundary x*, s* with
  x*'s* = 0, then b = A x*, c = A'y* + s*.  The optimal objective
  c'x* is stored in the .mat as ``pobj_star`` (exact oracle).
* ``portfolio``: Markowitz max-return SOCP with a risk budget
  (variables [t; y=Fw; w], cone SOC(1+k) x R+^n).
* ``nnlsq``: nonnegative least squares min 0.5||Dx-d||^2, x>=0 as an
  RSOC program (variables [t1,t2,z; x], cone RSOC(2+m) x R+^n); the
  oracle objective comes from scipy.optimize.nnls and is stored as
  ``pobj_star``.

Usage::

    python -m benchmarks.conic_mini -o benchmarks/suites/conic_mini
    python -m benchmarks.run_suite --sedumi benchmarks/suites/conic_mini --eps 1e-6
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import scipy.sparse as sp

from abip.cones import ConeSpec
from abip.io.sedumi import write_sedumi_mat


def _complementary_pair(cones: ConeSpec, rng):
    """Boundary x*, s* in K, K* (self-dual blocks) with x*'s* = 0.

    Block order matches `cones.ConeLayout`: [soc..., rsoc..., free,
    zero, nonneg].  SOC: x=(||v||,v), s=a(||v||,-v).  RSOC
    (t1,t2,z): x=(p, ||z||^2/(2p), z), s=b(x2, x1, -z).  free: s=0.
    zero: x=0, s free (dual of {0}).  nonneg: complementary support
    partition.  Note the SeDuMi WRITER rejects zero cones (the K struct
    has no primal zero field); zero-cone instances stay in-memory.
    """
    xs, ss = [], []
    for d in cones.soc:
        v = rng.standard_normal(d - 1) if d > 1 else np.zeros(0)
        nv = float(np.linalg.norm(v)) if d > 1 else rng.random() + 0.5
        xs.append(np.concatenate([[nv], v]))
        ss.append((rng.random() + 0.5) * np.concatenate([[nv], -v]))
    for d in cones.rsoc:
        z = rng.standard_normal(d - 2)
        p = rng.random() + 0.5
        q = float(z @ z) / (2.0 * p)
        xs.append(np.concatenate([[p, q], z]))
        ss.append((rng.random() + 0.5) * np.concatenate([[q, p], -z]))
    if cones.free:
        xs.append(rng.standard_normal(cones.free))
        ss.append(np.zeros(cones.free))
    if cones.zero:
        xs.append(np.zeros(cones.zero))
        ss.append(rng.standard_normal(cones.zero))
    if cones.nonneg:
        mask = rng.random(cones.nonneg) < 0.5
        pos = rng.random(cones.nonneg) + 0.5
        xs.append(np.where(mask, pos, 0.0))
        ss.append(np.where(mask, 0.0, pos))
    return np.concatenate(xs), np.concatenate(ss)


def randcone(name: str, m: int, cones: ConeSpec, seed: int):
    """Random conic program with known optimal objective (pobj_star)."""
    rng = np.random.default_rng(seed)
    n = cones.dim
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    A[rng.random((m, n)) < 0.5] = 0.0  # mild sparsity, CBLIB-like
    xstar, sstar = _complementary_pair(cones, rng)
    ystar = rng.standard_normal(m)
    b = A @ xstar
    c = A.T @ ystar + sstar
    return name, A, b, c, cones, float(c @ xstar)


def randqcp(name: str, m: int, cones: ConeSpec, seed: int, q_rank=None):
    """Random conic QP with known optimal objective.

    Same complementary-pair construction as :func:`randcone` extended
    with a PSD quadratic term: KKT stationarity is Qx + c - A'y = s, so
    c = A'y* + s* - Q x* makes (x*, y*, s*) optimal with
    pobj* = 0.5 x*'Qx* + c'x*.  q_rank=None gives full-rank dense Q;
    an int gives a rank-q_rank Q; "diag" gives a diagonal Q.
    """
    rng = np.random.default_rng(seed)
    n = cones.dim
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    A[rng.random((m, n)) < 0.5] = 0.0
    if q_rank == "diag":
        Q = rng.random(n) + 0.1          # 1-D diagonal
        Qx = lambda x: Q * x             # noqa: E731
        xQx = lambda x: float(x @ (Q * x))  # noqa: E731
    else:
        r = n if q_rank is None else int(q_rank)
        M = rng.standard_normal((r, n)) / np.sqrt(n)
        Q = M.T @ M + (0.1 * np.eye(n) if q_rank is None else 0.0)
        Qx = lambda x: Q @ x             # noqa: E731
        xQx = lambda x: float(x @ Q @ x)  # noqa: E731
    xstar, sstar = _complementary_pair(cones, rng)
    ystar = rng.standard_normal(m)
    b = A @ xstar
    c = A.T @ ystar + sstar - Qx(xstar)
    pobj = 0.5 * xQx(xstar) + float(c @ xstar)
    return name, A, b, c, Q, cones, pobj


def portfolio(n_assets: int, k: int, seed: int):
    """Markowitz max-return under a risk budget: max mu'w s.t. 1'w = 1,
    w >= 0, ||F w|| <= sigma.  Conic variables [t; y; w] with y = F w,
    t = sigma, cone SOC(1+k) x R+^n."""
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((k, n_assets)) / np.sqrt(k)
    mu = rng.random(n_assets)
    w0 = np.full(n_assets, 1.0 / n_assets)
    sigma = 2.0 * float(np.linalg.norm(F @ w0))
    n = 1 + k + n_assets
    A = np.zeros((k + 2, n))
    A[:k, 1:1 + k] = np.eye(k)
    A[:k, 1 + k:] = -F
    A[k, 1 + k:] = 1.0
    A[k + 1, 0] = 1.0
    b = np.concatenate([np.zeros(k), [1.0, sigma]])
    c = np.concatenate([np.zeros(1 + k), -mu])
    cones = ConeSpec(soc=(1 + k,), nonneg=n_assets)
    return f"port{n_assets}x{k}s{seed}", A, b, c, cones, None


def nnlsq(m: int, n: int, seed: int):
    """min 0.5||Dx - d||^2, x >= 0 as RSOC: variables [t1,t2,z; x],
    min t1 s.t. t2 = 1, z = Dx - d, (t1,t2,z) in RSOC(2+m), x >= 0.
    Oracle objective from scipy.optimize.nnls (pobj_star)."""
    from scipy.optimize import nnls as _nnls

    rng = np.random.default_rng(seed)
    D = rng.standard_normal((m, n))
    d = rng.standard_normal(m) + D @ (rng.random(n) * (rng.random(n) < 0.4))
    xh, rnorm = _nnls(D, d)
    nv = 2 + m + n
    A = np.zeros((1 + m, nv))
    A[0, 1] = 1.0                      # t2 = 1
    A[1:, 2:2 + m] = np.eye(m)         # z - Dx = -d
    A[1:, 2 + m:] = -D
    b = np.concatenate([[1.0], -d])
    c = np.zeros(nv)
    c[0] = 1.0
    cones = ConeSpec(rsoc=(2 + m,), nonneg=n)
    return f"nnlsq{m}x{n}s{seed}", A, b, c, cones, 0.5 * float(rnorm) ** 2


def instances():
    """The committed 12-instance conic-mini suite."""
    out = [
        randcone("rand_soc_a", 20, ConeSpec(soc=(8, 5, 3), nonneg=20), 11),
        randcone("rand_soc_b", 35, ConeSpec(soc=(16, 9), free=4, nonneg=30), 12),
        randcone("rand_rsoc_a", 25, ConeSpec(rsoc=(7, 5), nonneg=25), 13),
        randcone("rand_rsoc_b", 30, ConeSpec(rsoc=(12,), free=3, nonneg=28), 14),
        randcone("rand_mixed_a", 40,
                 ConeSpec(soc=(6, 4), rsoc=(5, 4), free=2, nonneg=32), 15),
        randcone("rand_mixed_b", 55,
                 ConeSpec(soc=(10,), rsoc=(8,), free=5, nonneg=60), 16),
        portfolio(24, 6, 21),
        portfolio(40, 10, 22),
        nnlsq(12, 30, 31),
        nnlsq(20, 45, 32),
        nnlsq(30, 25, 33),   # over-determined: active nonneg constraints
        randcone("rand_lp", 30, ConeSpec(nonneg=90), 17),
    ]
    return out


def write_suite(outdir: str):
    os.makedirs(outdir, exist_ok=True)
    written = []
    for name, A, b, c, cones, pobj_star in instances():
        path = os.path.join(outdir, f"{name}.mat")
        extra = {"pobj_star": pobj_star} if pobj_star is not None else None
        write_sedumi_mat(path, sp.csc_matrix(A), b, c, cones, extra=extra)
        written.append(path)
    return written


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-o", "--outdir", default="benchmarks/suites/conic_mini")
    args = ap.parse_args(argv)
    for p in write_suite(args.outdir):
        print(p)


if __name__ == "__main__":
    main()
