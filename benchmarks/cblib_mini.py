"""cblib-mini: a committed suite of native-CBF conic instances.

The reference's CBLIB protocol (`scripts/bench-qcp/test_cblib.m`) reads
.cbf instances through Mosek; our reader is native (`abip.io.cbf`).
CBLIB data itself is not redistributable here, so this suite re-exports
the conic-mini oracle instances (`benchmarks/conic_mini.instances`) as
.cbf text in THREE representations, exercising the whole reader:

* equality form (`write_cbf`): variables in cones, `L=` rows -- the
  direct standard-form dump;
* row form: all variables free, cone memberships as CONSTRAINT cone
  blocks (`Q`/`QR`/`L+` rows over identity coordinates), so the reader
  must synthesize slack blocks -- the shape real CBLIB files take;
* a MAX-sense variant with negated objective (optimum = -pobj_star).

The known optima land in `optima.json` ({name: objective in the
instance's own sense}), which `run_suite --cbf` uses for oracle checks.

Usage::

    python -m benchmarks.cblib_mini -o benchmarks/suites/cblib_mini
    python -m benchmarks.run_suite --cbf benchmarks/suites/cblib_mini --eps 1e-6
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import scipy.sparse as sp

from abip.cones import ConeSpec
from abip.io.cbf import write_cbf


def write_cbf_rowform(path, A, b, c, cones: ConeSpec, objsense="MIN",
                      comment=None):
    """Write `min c'x s.t. Ax = b, x in K` with the cones as CONSTRAINT
    rows: variables are declared free and each non-free cone block
    becomes a block of identity rows in the matching constraint cone.
    Reading this back yields an equivalent (slack-augmented) embedding.
    """
    A = sp.csc_matrix(A)
    m, n = A.shape
    cones.validate_dim(n)
    b = np.asarray(b, float).ravel()
    c = np.asarray(c, float).ravel()

    # constraint cone blocks: equality rows first, then memberships in
    # our column order [soc..., rsoc..., free(skipped), zero, nonneg]
    con_blocks = [("L=", m)]
    rows = []  # (var col) per membership row, in emission order
    j0 = 0
    for d in cones.soc:
        con_blocks.append(("Q", d))
        rows.extend(range(j0, j0 + d))
        j0 += d
    for d in cones.rsoc:
        con_blocks.append(("QR", d))
        rows.extend(range(j0, j0 + d))
        j0 += d
    j0 += cones.free
    if cones.zero:
        con_blocks.append(("L=", cones.zero))
        rows.extend(range(j0, j0 + cones.zero))
        j0 += cones.zero
    if cones.nonneg:
        con_blocks.append(("L+", cones.nonneg))
        rows.extend(range(j0, j0 + cones.nonneg))

    Ac = A.tocoo()
    obj_nz = np.nonzero(c)[0]
    b_nz = np.nonzero(b)[0]
    out = []
    if comment:
        out.append(f"# {comment}")
    out += ["VER", "2", "", "OBJSENSE", objsense, ""]
    out += ["VAR", f"{n} 1", f"F {n}", ""]
    out += ["CON", f"{m + len(rows)} {len(con_blocks)}"]
    out += [f"{name} {d}" for name, d in con_blocks]
    out += ["", "OBJACOORD", str(len(obj_nz))]
    out += [f"{j} {float(c[j])!r}" for j in obj_nz]
    out += ["", "ACOORD", str(Ac.nnz + len(rows))]
    out += [f"{i} {j} {float(v)!r}"
            for i, j, v in zip(Ac.row, Ac.col, Ac.data)]
    out += [f"{m + k} {j} 1.0" for k, j in enumerate(rows)]
    out += ["", "BCOORD", str(len(b_nz))]
    out += [f"{i} {float(-b[i])!r}" for i in b_nz]
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")


def write_suite(outdir: str):
    from benchmarks.conic_mini import instances

    os.makedirs(outdir, exist_ok=True)
    written, optima = [], {}
    for k, (name, A, b, c, cones, pobj_star) in enumerate(instances()):
        if k % 3 == 2:    # every third instance in natural row form
            fname = f"{name}_rows"
            write_cbf_rowform(os.path.join(outdir, fname + ".cbf"),
                              A, b, c, cones,
                              comment=f"conic-mini {name} (row form)")
            if pobj_star is not None:
                optima[fname] = pobj_star
        elif k % 3 == 1:  # every third as a MAX instance
            fname = f"{name}_max"
            write_cbf(os.path.join(outdir, fname + ".cbf"),
                      A, b, -np.asarray(c, float), cones, objsense="MAX",
                      comment=f"conic-mini {name} (negated, MAX sense)")
            if pobj_star is not None:
                optima[fname] = -pobj_star
        else:
            write_cbf(os.path.join(outdir, name + ".cbf"),
                      A, b, c, cones, comment=f"conic-mini {name}")
            if pobj_star is not None:
                optima[name] = pobj_star
        written.append(name)
    with open(os.path.join(outdir, "optima.json"), "w") as f:
        json.dump(optima, f, indent=1, sort_keys=True)
    return written


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-o", "--outdir", default="benchmarks/suites/cblib_mini")
    args = ap.parse_args(argv)
    for p in write_suite(args.outdir):
        print(p)


if __name__ == "__main__":
    main()
