"""Head-to-head conic parity: reference ABIP-QCP (QDLDL) vs abip.

Exports conic instances (cone order: soc, rsoc, free, zero, nonneg --
identical in both solvers) in the binary format read by the stub-built
reference driver (see tools/reference_qcp_driver_notes.md), runs both at
the same tolerance, and compares status / objective / iterations.

Usage::

    python tools/parity_qcp.py --ref-bin /tmp/qcpbench/qcpref --eps 1e-4 --cpu
"""
from __future__ import annotations

import argparse
import json
import struct
import subprocess
import sys
import tempfile

import numpy as np
import scipy.sparse as sp


def export_conic(path, A, b, c, cones, Q=None):
    """Q (optional): (n, n) dense/sparse quadratic term, written as a
    trailing CSC block read by the Q-aware driver build (qcpref_q; the
    Q=0 driver ignores trailing bytes)."""
    A = sp.csc_matrix(A)
    m, n = A.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<3q", m, n, A.nnz))
        f.write(np.asarray(A.indptr, "<i8").tobytes())
        f.write(np.asarray(A.indices, "<i8").tobytes())
        f.write(np.asarray(A.data, "<f8").tobytes())
        f.write(np.asarray(b, "<f8").tobytes())
        f.write(np.asarray(c, "<f8").tobytes())
        f.write(struct.pack("<5q", cones.free, cones.zero, cones.nonneg,
                            len(cones.soc), len(cones.rsoc)))
        if cones.soc:
            f.write(np.asarray(cones.soc, "<i8").tobytes())
        if cones.rsoc:
            f.write(np.asarray(cones.rsoc, "<i8").tobytes())
        if Q is not None:
            Qs = sp.csc_matrix(Q)
            f.write(struct.pack("<q", Qs.nnz))
            f.write(np.asarray(Qs.indptr, "<i8").tobytes())
            f.write(np.asarray(Qs.indices, "<i8").tobytes())
            f.write(np.asarray(Qs.data, "<f8").tobytes())


def instances(rng):
    from abip import ConeSpec

    out = []
    # SOC norm-min toys
    for d in (4, 8):
        a = rng.standard_normal(d)
        A = np.zeros((d, d + 1))
        A[:, 1:] = np.eye(d)
        c = np.zeros(d + 1)
        c[0] = 1.0
        out.append((f"soc{d}", A, a, c, ConeSpec(soc=(d + 1,))))
    # RSOC toy
    a = rng.standard_normal(3)
    A = np.zeros((4, 5))
    A[0, 1] = 1.0
    A[1:, 2:] = np.eye(3)
    b = np.concatenate([[1.0], a])
    c = np.zeros(5)
    c[0] = 1.0
    out.append(("rsoc", A, b, c, ConeSpec(rsoc=(5,))))
    # LP as conic
    m, n = 10, 30
    Ar = rng.standard_normal((m, n))
    b = Ar @ (rng.random(n) + 0.5)
    c = Ar.T @ rng.standard_normal(m) + rng.random(n) + 0.5
    out.append(("lp", Ar, b, c, ConeSpec(nonneg=n)))
    # mixed soc + nonneg (portfolio-like)
    k = 4
    F = rng.standard_normal((k, k)) / np.sqrt(k)
    n = 2 * k + 1
    A = np.zeros((1 + k, n))
    A[0, 1 + k:] = 1.0
    A[1:, 1 + k:] = F
    A[1:, 1:1 + k] = -np.eye(k)
    b = np.zeros(1 + k)
    b[0] = 1.0
    c = np.zeros(n)
    c[0] = 1.5
    c[1 + k:] = -rng.random(k)
    out.append(("mixed", A, b, c, ConeSpec(soc=(1 + k,), nonneg=k)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ref-bin", required=True)
    ap.add_argument("--eps", type=float, default=1e-4)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--count", type=int, default=1,
                    help="(--qp) seeds per QP family")
    ap.add_argument("--qp", action="store_true",
                    help="quadratic-objective families (randqcp exact "
                         "oracles); requires the Q-aware reference build "
                         "(qcpref_q -- recipe in "
                         "reference_qcp_driver_notes.md)")
    args = ap.parse_args(argv)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ".")
    import abip

    rng = np.random.default_rng(0)
    rows = []
    if args.qp:
        from abip import ConeSpec
        from benchmarks.conic_mini import randqcp

        gen = []
        for i, (cones, qk) in enumerate((
                (ConeSpec(nonneg=24), "diag"),
                (ConeSpec(nonneg=20), None),
                (ConeSpec(soc=(6,), nonneg=12), None),
                (ConeSpec(soc=(5,), rsoc=(4,), nonneg=9), "diag"),
                (ConeSpec(rsoc=(6,), nonneg=10), 3))):
            for s in range(args.count):
                nm, A, b, c, Q, cn, star = randqcp(
                    f"qp{i}s{s}", max(6, cones.dim // 3), cones,
                    100 + 17 * i + s, q_rank=qk)
                Qm = np.diag(Q) if np.ndim(Q) == 1 else Q
                gen.append((nm, A, b, c, cn, Qm, Q, star))
    else:
        gen = [(name, A, b, c, cones, None, None, None)
               for name, A, b, c, cones in instances(rng)]
    for name, A, b, c, cones, Qm, Q, star in gen:
        with tempfile.NamedTemporaryFile(suffix=".bin", delete=False) as f:
            export_conic(f.name, A, b, c, cones, Q=Qm)
            path = f.name
        ref = json.loads(subprocess.run(
            [args.ref_bin, path, str(args.eps)],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[-1])
        ours = abip.solve_qcp(A, b, c, cones, Q=Q, eps=args.eps)
        row = {
            "name": name,
            "ref_status": ref["status"], "our_status": ours.status_name,
            "ref_pobj": ref["pobj"], "our_pobj": ours.pobj,
            "pobj_rel_diff": abs(ref["pobj"] - ours.pobj) / (1 + abs(ref["pobj"])),
            "ref_admm": ref["admm"], "our_admm": ours.admm_iters,
        }
        if star is not None:
            row["pobj_star"] = star
            row["ref_star_err"] = abs(ref["pobj"] - star) / (1 + abs(star))
            row["our_star_err"] = abs(ours.pobj - star) / (1 + abs(star))
        rows.append(row)
        print(json.dumps(row))
    diffs = [r["pobj_rel_diff"] for r in rows
             if r["ref_status"].startswith("Solved")
             and r["our_status"].startswith("Solved")]
    print(f"# both-solved objective agreement: max rel diff "
          f"{max(diffs):.2e} over {len(diffs)} instances")
    return rows


if __name__ == "__main__":
    main()
