"""Randomized conic validation with exact complementary-pair oracles.

The LP analogue is `tools/fuzz_scipy.py`; here each instance is a random
conic program built around a KNOWN boundary-complementary primal-dual
pair (`benchmarks/conic_mini._complementary_pair`), so the exact optimal
objective is available without an external solver.  Pass criteria per
solved instance:

  * objective within 50*eps of the exact oracle,
  * KKT at the returned point: primal feasibility, cone membership of x
    and s (to eps-level violation), complementarity gap.

Classes cover the full cone set {nonneg, SOC, RSOC, free, mixed} and a
diagonal-Q variant.  One JSONL line per instance + a summary.

Usage::

    python tools/fuzz_conic.py --per-class 20 --eps 1e-6 -o out.jsonl
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import zlib

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def cone_violation(v, cones, dual=False):
    """Max violation of membership v in K (dual=False) or K* (dual=True).

    soc/rsoc/nonneg are self-dual; the free block is unconstrained in K
    but must be 0 in K* (dual of a subspace), and the zero block must be
    0 in K but is unconstrained in K*.
    """
    viol = 0.0
    o = 0
    for d in cones.soc:
        blk = v[o:o + d]
        viol = max(viol, float(np.linalg.norm(blk[1:]) - blk[0]))
        o += d
    for d in cones.rsoc:
        blk = v[o:o + d]
        viol = max(viol,
                   float(np.linalg.norm(blk[2:]) ** 2
                         - 2.0 * max(blk[0], 0.0) * max(blk[1], 0.0)),
                   float(-blk[0]), float(-blk[1]))
        o += d
    if cones.free and dual:
        viol = max(viol, float(np.abs(v[o:o + cones.free]).max()))
    o += cones.free
    if cones.zero and not dual:
        viol = max(viol, float(np.abs(v[o:o + cones.zero]).max()))
    o += cones.zero
    if cones.nonneg:
        viol = max(viol, float(-(v[o:]).min()) if v[o:].size else 0.0)
    return viol


CLASSES = {
    "nonneg": lambda C: C(nonneg=25),
    "soc": lambda C: C(soc=(8, 5), nonneg=10),
    "rsoc": lambda C: C(rsoc=(7, 4), nonneg=8),
    "free_mixed": lambda C: C(soc=(6,), free=4, nonneg=12),
    "mixed": lambda C: C(soc=(5,), rsoc=(4,), free=3, nonneg=9),
    "zero_mixed": lambda C: C(soc=(6,), free=2, zero=3, nonneg=10),
}

# quadratic-objective classes (randqcp oracle): q_kind "diag" or full;
# excluded from --method pdhg (no closed prox for coupled Q)
QP_CLASSES = {
    "qp_diag": (lambda C: C(soc=(6,), nonneg=14), "diag"),
    "qp_full": (lambda C: C(soc=(5,), rsoc=(4,), nonneg=11), None),
    "qp_lowrank": (lambda C: C(nonneg=20), 3),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--per-class", type=int, default=20)
    ap.add_argument("--eps", type=float, default=1e-6)
    ap.add_argument("--batched", action="store_true",
                    help="solve each class as ONE vmapped program "
                         "(solve_qcp_batch, mixed precision + built-in "
                         "equilibration)")
    ap.add_argument("--engine", default="steps",
                    choices=["steps", "sprint2", "delta"],
                    help="batched device engine (sprint2 = fused phase 1 "
                         "+ delta endgame default; delta = single-phase "
                         "anchored-delta)")
    ap.add_argument("--method", default="admm", choices=["admm", "pdhg"],
                    help="pdhg = the conic restarted-PDHG competitor "
                         "(solve_qcp_pdhg) under the same KKT contract")
    ap.add_argument("-o", "--out", default=None)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    from abip import ConeSpec, solve_qcp
    from abip.qcp import conic_defaults

    from benchmarks.conic_mini import randcone, randqcp

    lines = []
    bad = 0
    all_classes = {cls: (mk, False) for cls, mk in CLASSES.items()}
    if args.method != "pdhg":   # PDHG has no prox for coupled Q
        all_classes.update({cls: (mkq, True)
                            for cls, mkq in QP_CLASSES.items()})
    for cls, (mk, is_qp) in all_classes.items():
        q_kind = mk[1] if is_qp else None
        cones = (mk[0] if is_qp else mk)(ConeSpec)
        m = max(6, cones.dim // 3)
        insts = []   # (name, A, b, c, Q-or-None, pobj_star)
        for i in range(args.per_class):
            seed = zlib.crc32(f"conic:{cls}:{i}".encode())
            if is_qp:
                nm, A, b, c, Q, _cn, star = randqcp(
                    f"{cls}{i}", m, cones, seed, q_rank=q_kind)
                insts.append((nm, A, b, c, Q, star))
            else:
                nm, A, b, c, _cn, star = randcone(f"{cls}{i}", m, cones,
                                                  seed)
                insts.append((nm, A, b, c, None, star))
        if args.batched:
            import jax.numpy as jnp

            from abip.parallel.batched_qcp import solve_qcp_batch

            As = jnp.asarray(np.stack([t[1] for t in insts]))
            bs = jnp.asarray(np.stack([t[2] for t in insts]))
            cs = jnp.asarray(np.stack([t[3] for t in insts]))
            t0 = time.perf_counter()
            # rho_y=1e-3: the mixed f32 Schur factor needs
            # cond(S) ~ 1/rho_y manageable (see solve_qcp_batch docs).
            # max_admm is the TOTAL budget in the device driver (host
            # total is max_admm*max_ipm); hard instances can need
            # hundreds of thousands of iterations (nonneg:10 solves at
            # ~300k where the host driver took 270k).
            Qs = (jnp.asarray(np.stack([t[4] for t in insts]))
                  if is_qp else None)
            # full (2-D) Q forces the steps engine (the fused phase-1
            # sprint and delta kernels take diagonal Q only)
            eng = ("steps" if (Qs is not None and Qs.ndim == 3)
                   else args.engine)
            rb = solve_qcp_batch(As, bs, cs, Qs, cones=cones, eps=args.eps,
                                 precision="mixed", normalize=True,
                                 rho_y=1e-3, max_admm=1_000_000,
                                 engine=eng)
            batch_wall = time.perf_counter() - t0
        for i in range(args.per_class):
            name, A, b, c, Q, pobj_star = insts[i]
            if args.batched:
                from abip.settings import Status

                class _S:  # adapt the batch lane to the solution shape
                    pass

                sol = _S()
                sol.status_name = Status.name(int(rb.status[i]))
                sol.admm_iters = int(rb.admm_iters[i])
                sol.pobj = float(rb.pobj[i])
                sol.x = np.asarray(rb.x[i])
                sol.y = np.asarray(rb.y[i])
                sol.s = np.asarray(rb.s[i])
                wall = batch_wall / args.per_class
            elif args.method == "pdhg":
                from abip.pdhg import solve_qcp_pdhg

                t0 = time.perf_counter()
                sol = solve_qcp_pdhg(A, b, c, cones, eps=args.eps,
                                     max_iters=1_000_000)
                wall = time.perf_counter() - t0
            else:
                t0 = time.perf_counter()
                sol = solve_qcp(A, b, c, cones, Q=Q,
                                settings=conic_defaults(), eps=args.eps)
                wall = time.perf_counter() - t0
            rec = {"class": cls, "i": i, "status": sol.status_name,
                   "admm": int(sol.admm_iters), "time": round(wall, 3)}
            ok = sol.status_name.startswith("Solved")
            if ok:
                rec["obj_err"] = float(
                    abs(sol.pobj - pobj_star) / max(1.0, abs(pobj_star)))
                x, y, s = sol.x, sol.y, sol.s
                pres = np.linalg.norm(A @ x - b) / (1 + np.linalg.norm(b))
                comp = abs(float(x @ s)) / (1 + abs(sol.pobj))
                rec["kkt"] = float(max(pres, comp))
                rec["cone_viol_x"] = float(cone_violation(x, cones))
                rec["cone_viol_s"] = float(cone_violation(s, cones,
                                                          dual=True))
                tol = 50 * args.eps
                ok = (rec["obj_err"] < tol and rec["kkt"] < tol
                      and rec["cone_viol_x"] < tol
                      and rec["cone_viol_s"] < tol)
            rec["ok"] = bool(ok)
            bad += not ok
            lines.append(rec)
            print(json.dumps(rec))
    summary = {"total": len(lines), "mismatches": bad,
               "per_class": args.per_class, "eps": args.eps}
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            for rec in lines + [summary]:
                f.write(json.dumps(rec) + "\n")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
