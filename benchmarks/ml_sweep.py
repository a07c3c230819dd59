"""ML application sweeps: LASSO and SVM grids with oracle cross-checks.

The reference's QCP bench layer sweeps LASSO over an (m, n) grid in both
the SOCP and QP-style forms and SVM over C values, comparing objectives
across solvers and aggregating with SGM-10
(`/root/reference/scripts/bench-qcp/test_lasso.m:36-120`, `test_svm.m`,
`calculate_SGM.m:3`).  This driver runs the same protocol (scaled by
--scale for CPU-budget runs) with independent oracles in place of the
commercial competitors this environment lacks:

  * LASSO: proximal-gradient (ISTA) with backtracking -- provably
    converges to the same global optimum, so the objective gap is a
    correctness check, not a horse race.
  * SVM: the QP and SOCP embeddings of the SAME instance must agree with
    each other (two independent reformulations, one optimum).

Records use the run_suite JSON schema plus `obj_err`; use
`python -m benchmarks.analyze <outdir>` for SGM-10 tables.

Usage::

    python -m benchmarks.ml_sweep --kind lasso --scale 0.1 --cpu -o out/
    python -m benchmarks.ml_sweep --kind svm --cpu -o out/
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import jax

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


def _spec_norm_sq(X, iters=60, seed=0):
    """Largest singular value squared by power iteration: the full SVD
    behind np.linalg.norm(X, 2) costs minutes at the paper scale
    (5000 x 15000)."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(X.shape[1])
    v /= np.linalg.norm(v)
    s = 0.0
    for _ in range(iters):
        w = X.T @ (X @ v)
        s = np.linalg.norm(w)
        v = w / max(s, 1e-30)
    return s * 1.02     # small cushion keeps the ISTA step valid


def ista_lasso(X, y, lam, iters=5000, tol=1e-10):
    """Proximal gradient with FISTA momentum: oracle for
    min 1/2||Xw - y||^2 + lam*||w||_1."""
    L = _spec_norm_sq(X)
    w = np.zeros(X.shape[1])
    z = w.copy()
    t = 1.0
    obj_prev = np.inf
    for _ in range(iters):
        g = X.T @ (X @ z - y)
        w_new = z - g / L
        w_new = np.sign(w_new) * np.maximum(np.abs(w_new) - lam / L, 0.0)
        t_new = 0.5 * (1 + np.sqrt(1 + 4 * t * t))
        z = w_new + (t - 1) / t_new * (w_new - w)
        w, t = w_new, t_new
        obj = 0.5 * np.linalg.norm(X @ w - y) ** 2 + lam * np.abs(w).sum()
        if abs(obj_prev - obj) < tol * max(1.0, abs(obj)):
            break
        obj_prev = obj
    return w, obj


def export_ml(path, X, y, lam, prob_type=0):
    """Binary instance for tools/refqcp/ml_driver.c (the reference
    abip_ml front door without MATLAB)."""
    import struct

    import scipy.sparse as sp

    Xs = sp.csc_matrix(X)
    m, n = Xs.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<q", prob_type))
        f.write(struct.pack("<3q", m, n, Xs.nnz))
        f.write(np.asarray(Xs.indptr, "<i8").tobytes())
        f.write(np.asarray(Xs.indices, "<i8").tobytes())
        f.write(np.asarray(Xs.data, "<f8").tobytes())
        f.write(np.asarray(y, "<f8").tobytes())
        f.write(struct.pack("<d", float(lam)))


def run_reference_ml(ref_bin, X, y, lam, eps, prob_type=0, tlimit=2000.0):
    """One reference abip_ml solve on exported data; returns the parsed
    JSON record or an error dict."""
    import subprocess
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".bin")
    os.close(fd)
    try:
        export_ml(path, X, y, lam, prob_type=prob_type)
        out = subprocess.run([ref_bin, path, f"{eps:g}", f"{tlimit:g}"],
                             capture_output=True, text=True,
                             timeout=tlimit + 300)
        line = [ln for ln in out.stdout.strip().splitlines()
                if ln.startswith("{")][-1]
        return json.loads(line)
    except Exception as e:  # noqa: BLE001 -- record the failure, keep sweeping
        return {"error": repr(e)}
    finally:
        os.unlink(path)


def sweep_lasso_ref_only(scale, eps, outdir, ref_bin, tlimit=2000.0,
                         oracle=True):
    """Reference + oracle columns only (CPU): runs concurrently with the
    device pass over the same seeded grid; merge by instance name."""
    from benchmarks.generate import lasso_instance

    ms = [int(m * scale) for m in (1000, 2000, 5000)]
    ns = [int(n * scale) for n in (5000, 10000, 15000)]
    out = []
    for m in ms:
        for n in ns:
            # resumable: a ref run at paper scale costs 27-550+ s, so a
            # re-launched sweep must not repeat finished instances
            done = os.path.join(outdir or ".", f"lasso_m{m}_n{n}_ref.json")
            if outdir and os.path.exists(done):
                with open(done) as f:
                    rec = json.load(f)
                out.append(rec)
                print(json.dumps(rec) + "  # cached", flush=True)
                continue
            X, y, lam = lasso_instance(m=m, n=n, seed=m + n)
            ref = run_reference_ml(ref_bin, X, y, lam, eps, prob_type=0,
                                   tlimit=tlimit)
            rec = {"name": f"lasso_m{m}_n{n}_ref", "ref": ref}
            if "time_sec" in ref:
                rec["ref_time"] = ref["time_sec"]
                rec["ref_status"] = ref["status"]
                rec["ref_admm"] = ref["admm"]
            if oracle:
                _, obj_star = ista_lasso(X, y, lam)
                rec["obj_star"] = obj_star
                if "pobj" in ref:
                    rec["ref_obj_err"] = (abs(ref["pobj"] - obj_star)
                                          / max(1.0, abs(obj_star)))
            out.append(rec)
            _write(outdir, rec)
            print(json.dumps(rec), flush=True)
    return out


def _lasso_embed_device(Xj, yj, lam):
    """The RSOC embedding of `lasso_to_conic` built ON DEVICE: only X
    travels to the device, never the (m+1) x (2+m+2n) reformulated
    matrix.  lam is a TRACED scalar so the jitted shell
    below caches per SHAPE (a closure float would re-trace per call --
    measured 12.5 s of 'setup' that was really an embed recompile)."""
    import jax.numpy as jnp

    m, n = Xj.shape
    p, q = m + 1, 2 + m + 2 * n
    A = jnp.zeros((p, q), Xj.dtype)
    A = A.at[0, 0].set(1.0)
    A = A.at[1:, 2 : 2 + m].set(jnp.eye(m, dtype=Xj.dtype))
    A = A.at[1:, 2 + m : 2 + m + n].set(Xj)
    A = A.at[1:, 2 + m + n :].set(-Xj)
    b = jnp.concatenate([jnp.ones((1,), Xj.dtype), yj])
    lam = jnp.asarray(lam, Xj.dtype)
    c = jnp.zeros((q,), Xj.dtype).at[1].set(1.0).at[2 + m :].set(lam)
    return A, b, c


def _lasso_embed_batched(Xd, yd, lam):
    A, b, c = _lasso_embed_device(Xd, yd, lam)
    return A[None], b[None], c[None]


def _lasso_embed_host(X, y, lam):
    """Numpy mirror of `_lasso_embed_device` for the host-polish stage:
    rebuilding the (m+1) x (2+m+2n) embedding from X costs milliseconds
    on host RAM, less than downloading the device copy."""
    m, n = X.shape
    p, q = m + 1, 2 + m + 2 * n
    A = np.zeros((p, q))
    A[0, 0] = 1.0
    A[1:, 2 : 2 + m] = np.eye(m)
    A[1:, 2 + m : 2 + m + n] = X
    A[1:, 2 + m + n :] = -X
    b = np.concatenate([[1.0], np.asarray(y, float)])
    c = np.zeros(q)
    c[1] = 1.0
    c[2 + m :] = float(lam)
    return A, b, c


_lasso_embed_jit = None


def _embed_jit():
    global _lasso_embed_jit
    if _lasso_embed_jit is None:
        import jax

        _lasso_embed_jit = jax.jit(_lasso_embed_batched)
    return _lasso_embed_jit


def solve_lasso_device(X, y, lam, eps):
    """LASSO through the whole-solve-on-device conic driver (B=1).

    The device route for the paper-scale grid: the dense RSOC embedding
    (built on device by `_lasso_embed_device`) through the ladder
    phase 1 + anchored-delta endgame, with the setup chain
    (equilibration + Woodbury (m+1)^2 Newton factor + r-vector) paid
    ONCE via `prepare_conic_batch` and shared by every capped resume
    round."""
    import jax.numpy as jnp
    import numpy as np

    from abip import ConeSpec
    from abip.parallel.batched_qcp import (_solve_qcp_batch_jit,
                                               prepare_conic_batch)

    m, n = X.shape
    cones = ConeSpec(rsoc=(2 + m,), nonneg=2 * n)
    Xj = jnp.asarray(X)
    yj = jnp.asarray(y)
    jax.block_until_ready(jnp.sum(Xj) + jnp.sum(yj))         # stage the upload off-clock

    t0 = time.perf_counter()
    Ab, bb, cb = _embed_jit()(Xj, yj, jnp.asarray(lam))
    prep = prepare_conic_batch(Ab, bb, cb, cones=cones, rho_y=1e-3,
                               precision="mixed", normalize=True)
    kw = dict(cones=cones, eps=eps, precision="mixed", rho_y=1e-3,
              normalize=False, solver="inverse", cadence="chunk",
              inner_crit_period=512, probe_period=8, max_admm=1_000_000)
    # phase 1: the one-loop barrier ladder to the mu switch
    res = _solve_qcp_batch_jit(Ab, bb, cb, None, engine="ladder",
                               prepared=prep, sprint_mu_switch=1e-3,
                               mu_stop=1e-3, **kw)
    st = (res.u_raw, res.v_raw, res.mu, res.tol_inner,
          res.admm_iters, res.ipm_iters, res.status)
    status = int(np.asarray(res.status)[0])
    k = int(np.asarray(res.admm_iters)[0])
    setup_p1_s = time.perf_counter() - t0
    # phase 2: capped anchored-delta resume rounds (adapted toward
    # ~25 s/round, SCALAR caps).  Wide embeddings rely on the delta
    # engine's stage-stall guard (the f32 criterion floors ~sqrt(q)*
    # eps32; a stalled stage advances the barrier after 8*T iterations).
    chunk, prev_k = 2048, -1
    best_pres = float("inf")
    while status == 0 and k < kw["max_admm"] and k > prev_k:
        prev_k = k
        t1 = time.perf_counter()
        res = _solve_qcp_batch_jit(
            Ab, bb, cb, None, engine="delta", prepared=prep,
            init_state=st, k_cap=np.int32(k + chunk), **kw)
        status = int(np.asarray(res.status)[0])
        k = int(np.asarray(res.admm_iters)[0])
        st = (res.u_raw, res.v_raw, res.mu, res.tol_inner,
              res.admm_iters, res.ipm_iters, res.status)
        round_s = max(time.perf_counter() - t1, 1e-3)
        # f32 floor signature: dual + gap certified, primal pinned near
        # (but above) eps across a full >=2048-iteration round.  Stop
        # burning stall-advance rounds and hand the last stage to the
        # host polish, which re-certifies everything in f64.
        pres = float(np.asarray(res.res_pri)[0])
        if (status == 0 and k - prev_k >= 2048
                and float(np.asarray(res.res_dual)[0]) < eps
                and float(np.asarray(res.rel_gap)[0]) < eps
                and eps <= pres < 50 * eps and pres > 0.9 * best_pres):
            status = 2
            break
        best_pres = min(best_pres, pres)
        chunk = int(min(65536, max(256, chunk * 25.0 / round_s)))

    polish_s = 0.0
    psol = None
    if status == 2:
        # Solved/Inaccurate = the anchored-f32 primal-residual floor
        # (~sqrt(q)*eps32 at wide embeddings): finish the last barrier
        # stage in native f64 from the batch lane's state.
        from abip.parallel.batched_qcp import host_polish

        t2 = time.perf_counter()
        Ah, bh, ch = _lasso_embed_host(X, y, lam)
        psol = host_polish(Ah, bh, ch, cones, res, lane=0, eps=eps,
                           rho_y=1e-3)
        polish_s = time.perf_counter() - t2

    if psol is not None:
        z = np.asarray(psol.x)
    else:
        z = np.asarray(res.x[0])
    w = z[2 + m:2 + m + n] - z[2 + m + n:]
    obj = 0.5 * np.sum((X @ w - y) ** 2) + lam * np.abs(w).sum()
    dev_status, dev_k = status, k

    class _Sol:
        if psol is not None:
            status_name = psol.status_name
            ipm_iters = int(res.ipm_iters[0]) + psol.ipm_iters
            admm_iters = int(res.admm_iters[0]) + psol.admm_iters
            res_pri = float(psol.res_pri)
            res_dual = float(psol.res_dual)
            rel_gap = float(psol.rel_gap)
            pobj = float(psol.pobj)
            dobj = float(psol.dobj)
            polish_sec = polish_s
            polish_admm = int(psol.admm_iters)
            device_status = int(dev_status)
            device_admm = int(dev_k)
        else:
            status_name = ("Solved" if int(res.status[0]) == 1
                           else f"status{int(res.status[0])}")
            ipm_iters = int(res.ipm_iters[0])
            admm_iters = int(res.admm_iters[0])
            res_pri = float(res.res_pri[0])
            res_dual = float(res.res_dual[0])
            rel_gap = float(res.rel_gap[0])
            pobj = float(res.pobj[0])
            dobj = float(res.dobj[0])
        setup_p1_sec = setup_p1_s      # prepare + embed + ladder phase

    return w, obj, _Sol()


def sweep_lasso(scale, eps, outdir, matrix_free=False, method="abip",
                ref_bin=None, tlimit=2000.0, oracle=True, cells=None):
    from benchmarks.generate import lasso_instance

    from abip.problems import solve_lasso

    ms = [int(m * scale) for m in (1000, 2000, 5000)]
    ns = [int(n * scale) for n in (5000, 10000, 15000)]
    out = []
    for m in ms:
        for n in ns:
            if cells is not None and (m, n) not in cells:
                continue
            X, y, lam = lasso_instance(m=m, n=n, seed=m + n)
            done = os.path.join(outdir or ".", f"lasso_m{m}_n{n}.json")
            if outdir and os.path.exists(done):
                with open(done) as f:
                    rec = json.load(f)
                out.append(rec)
                print(json.dumps(rec) + "  # cached", flush=True)
                continue
            if method == "device":
                # warm the shape's programs OFF the clock with a
                # DIFFERENT draw
                Xw, yw, lw = lasso_instance(m=m, n=n, seed=m + n + 999)
                solve_lasso_device(Xw, yw, lw, eps)
            t0 = time.perf_counter()
            if method == "device":
                w, obj, sol = solve_lasso_device(X, y, lam, eps)
            elif method == "pdhg":
                # first-order competitor on the same RSOC embedding
                # (the SCS-conic column of `test_lasso.m:36-120`)
                from abip.pdhg import solve_qcp_pdhg
                from abip.problems.lasso import lasso_to_conic

                prob = lasso_to_conic(X, y, lam)
                sol = solve_qcp_pdhg(prob.A, prob.b, prob.c, prob.cones,
                                     eps=eps)
                w, obj = prob.recover(sol)
            else:
                w, obj, sol = solve_lasso(X, y, lam, eps=eps,
                                          matrix_free=matrix_free)
            wall = time.perf_counter() - t0
            obj_star = ista_lasso(X, y, lam)[1] if oracle else float("nan")
            rec = {
                "name": f"lasso_m{m}_n{n}",
                "status": sol.status_name,
                "ipm_iter": int(sol.ipm_iters),
                "admm_iter": int(sol.admm_iters),
                "pres": float(sol.res_pri), "dres": float(sol.res_dual),
                "gap": float(sol.rel_gap),
                # dobj is the SOLVER's dual objective (the reference
                # always reports one, `abip.h:139-158`); the ISTA oracle
                # optimum travels separately as obj_star/obj_err
                "pobj": float(obj),
                "dobj": float(getattr(sol, "dobj", float("nan"))),
                "obj_star": float(obj_star),
                "obj_err": abs(obj - obj_star) / max(1.0, abs(obj_star)),
                "time": wall,
            }
            if hasattr(sol, "setup_p1_sec"):
                rec["setup_p1_sec"] = round(float(sol.setup_p1_sec), 3)
            for f in ("polish_sec", "polish_admm", "device_status",
                      "device_admm"):
                if hasattr(sol, f):
                    rec[f] = (round(float(getattr(sol, f)), 3)
                              if f == "polish_sec" else int(getattr(sol, f)))
            if ref_bin:
                ref = run_reference_ml(ref_bin, X, y, lam, eps,
                                       prob_type=0, tlimit=tlimit)
                rec["ref"] = ref
                if "time_sec" in ref:
                    rec["ref_time"] = ref["time_sec"]
                    rec["ref_status"] = ref["status"]
                    rec["ref_admm"] = ref["admm"]
                    rec["ref_obj_err"] = (abs(ref["pobj"] - obj_star)
                                          / max(1.0, abs(obj_star)))
                    rec["speedup_vs_ref"] = ref["time_sec"] / max(wall, 1e-9)
            out.append(rec)
            _write(outdir, rec)
            print(json.dumps(rec))
    return out


def sweep_svm(scale, eps, outdir):
    from benchmarks.generate import svm_instance

    from abip.problems import solve_svm

    shapes = [(int(500 * scale), int(50 * scale)),
              (int(1000 * scale), int(100 * scale))]
    out = []
    for m, n in shapes:
        for C in (0.1, 1.0):
            X, y = svm_instance(m=max(m, 8), n=max(n, 4), seed=m + n)
            recs = {}
            for form in ("qp", "socp"):
                t0 = time.perf_counter()
                w, b0, obj, sol = solve_svm(X, y, C, form=form, eps=eps)
                recs[form] = (obj, sol, time.perf_counter() - t0)
            obj_qp, sol_qp, t_qp = recs["qp"]
            obj_socp, sol_socp, t_socp = recs["socp"]
            rec = {
                "name": f"svm_m{max(m, 8)}_n{max(n, 4)}_C{C}",
                "status": sol_qp.status_name,
                "status_socp": sol_socp.status_name,
                "admm_iter": int(sol_qp.admm_iters),
                "admm_iter_socp": int(sol_socp.admm_iters),
                "pobj": float(obj_qp), "pobj_socp": float(obj_socp),
                "obj_err": abs(obj_qp - obj_socp)
                / max(1.0, abs(obj_qp)),
                "time": t_qp, "time_socp": t_socp,
            }
            out.append(rec)
            _write(outdir, rec)
            print(json.dumps(rec))
    return out


def libsvm_like_instance(m, n, nnz_per_row=14, seed=0):
    """Synthetic a9a/w8a-shaped data: m samples of n sparse BINARY
    features (~nnz_per_row active each, the a9a density), labels from a
    planted hyperplane with 10% flip noise.  The real sets
    (`test_svm.m:44-52`) are environment-blocked (no egress); this
    reproduces their shape and sparsity, not their distribution."""
    rng = np.random.default_rng(seed)
    X = np.zeros((m, n))
    for i in range(m):
        idx = rng.choice(n, size=min(nnz_per_row, n), replace=False)
        X[i, idx] = 1.0
    w = rng.standard_normal(n)
    b0 = rng.standard_normal()
    y = np.sign(X @ w + b0 + 0.5 * rng.standard_normal(m))
    y[y == 0] = 1.0
    flip = rng.random(m) < 0.10
    y[flip] = -y[flip]
    return X, y


def sweep_svm_scale(eps, outdir, ref_bin=None, shapes=((10_000, 123),
                                                       (20_000, 300)),
                    C=1.0, tlimit=2000.0):
    """Realistic-scale SVM (a9a/w8a shapes): QP and SOCP matrix-free
    forms must agree with each other, with a wall column from the
    reference abip_ml binary (prob_type 1 = SOCP, 3 = QP;
    `mex/abip_ml_mex.c:90-268`) on the SAME data.  The r04 sweep
    validated cross-form agreement only at m<=1000 synthetic scale."""
    from abip.problems import solve_svm

    out = []
    for m, n in shapes:
        name = f"svmscale_m{m}_n{n}_C{C:g}"
        done = os.path.join(outdir or ".", name + ".json")
        if outdir and os.path.exists(done):
            with open(done) as f:
                rec = json.load(f)
            out.append(rec)
            print(json.dumps(rec) + "  # cached", flush=True)
            continue
        X, y = libsvm_like_instance(m, n, seed=m + n)
        recs = {}
        for form in ("qp", "socp"):
            t0 = time.perf_counter()
            w, b0, obj, sol = solve_svm(X, y, C, form=form, eps=eps,
                                        matrix_free=True)
            recs[form] = (obj, sol, time.perf_counter() - t0)
        obj_qp, sol_qp, t_qp = recs["qp"]
        obj_socp, sol_socp, t_socp = recs["socp"]
        rec = {
            "name": name, "m": m, "n": n, "C": C,
            "status": sol_qp.status_name,
            "status_socp": sol_socp.status_name,
            "admm_iter": int(sol_qp.admm_iters),
            "admm_iter_socp": int(sol_socp.admm_iters),
            "pres": float(sol_qp.res_pri), "dres": float(sol_qp.res_dual),
            "gap": float(sol_qp.rel_gap),
            "pobj": float(obj_qp), "pobj_socp": float(obj_socp),
            "dobj": float(sol_qp.dobj),
            "form_gap": abs(obj_qp - obj_socp) / max(1.0, abs(obj_qp)),
            "time": t_qp, "time_socp": t_socp,
        }
        if ref_bin and os.path.exists(ref_bin):
            for ptype, label in ((3, "ref_qp"), (1, "ref_socp")):
                ref = run_reference_ml(ref_bin, X, y, C, eps,
                                       prob_type=ptype, tlimit=tlimit)
                if "time_sec" in ref:
                    rec[label + "_time"] = ref["time_sec"]
                    rec[label + "_status"] = ref["status"]
                    rec[label + "_admm"] = ref["admm"]
                    rec[label + "_pobj"] = ref.get("pobj")
                else:
                    rec[label + "_error"] = ref.get("error", "no output")
        out.append(rec)
        _write(outdir, rec)
        print(json.dumps(rec), flush=True)
    return out


def _validate_solved(rec):
    """A status of Solved is unclaimable without finite certificates:
    the reference always reports a finite dual objective alongside the
    primal (`/root/reference/src/abip-qcp/include/abip.h:139-158`).
    Downgrade any Solved record with non-finite pobj/dobj/residuals to
    'Unverified' so a broken extract path cannot masquerade as a win."""
    if rec.get("status") != "Solved":
        return rec
    import math as _math

    bad = [k for k in ("pobj", "dobj", "pres", "dres", "gap")
           if k in rec and not _math.isfinite(float(rec[k]))]
    if bad:
        rec["status"] = "Unverified"
        rec["unverified_fields"] = bad
    return rec


def _write(outdir, rec):
    _validate_solved(rec)
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, f"{rec['name']}.json"), "w") as f:
            json.dump(rec, f, indent=2)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--kind", choices=["lasso", "svm", "svm-scale"],
                    required=True)
    ap.add_argument("--scale", type=float, default=0.1,
                    help="grid scale vs the reference protocol (1.0 = "
                         "test_lasso.m's m up to 5000, n up to 15000)")
    ap.add_argument("--eps", type=float, default=1e-4)
    ap.add_argument("--matrix-free", action="store_true")
    ap.add_argument("--method", default="abip",
                    choices=["abip", "pdhg", "device"],
                    help="pdhg = conic restarted PDHG on the same RSOC "
                         "embedding (lasso only; the SCS-conic column)")
    ap.add_argument("--ref-only", action="store_true",
                    help="run ONLY the reference + oracle columns (CPU "
                         "side of a split sweep; merge by name)")
    ap.add_argument("--no-oracle", action="store_true",
                    help="skip the ISTA oracle (CPU-expensive at paper "
                         "scale; the ref-only pass records it instead)")
    ap.add_argument("--ref-bin", default=None,
                    help="reference abip_ml binary (tools/refqcp/"
                         "ml_driver.c); adds ref_* columns per instance")
    ap.add_argument("--tlimit", type=float, default=2000.0,
                    help="per-instance cap, both sides (test_lasso.m: "
                         "2000 s)")
    ap.add_argument("--cells", default=None,
                    help="restrict the lasso grid to 'MxN,MxN,...' cells")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("-o", "--outdir", default=None)
    args = ap.parse_args(argv)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    if args.kind == "lasso":
        if args.ref_only:
            if not args.ref_bin:
                raise SystemExit("--ref-only needs --ref-bin")
            sweep_lasso_ref_only(args.scale, args.eps, args.outdir,
                                 args.ref_bin, tlimit=args.tlimit,
                                 oracle=not args.no_oracle)
        else:
            cells = None
            if args.cells:
                cells = {tuple(int(v) for v in c.split("x"))
                         for c in args.cells.split(",")}
            sweep_lasso(args.scale, args.eps, args.outdir,
                        matrix_free=args.matrix_free, method=args.method,
                        ref_bin=args.ref_bin, tlimit=args.tlimit,
                        oracle=not args.no_oracle, cells=cells)
    elif args.kind == "svm-scale":
        sweep_svm_scale(args.eps, args.outdir, ref_bin=args.ref_bin,
                        tlimit=args.tlimit)
    else:
        if args.method != "abip":
            raise SystemExit("--method pdhg applies to --kind lasso (the "
                             "SVM QP form carries Q)")
        sweep_svm(args.scale, args.eps, args.outdir)


if __name__ == "__main__":
    main()
