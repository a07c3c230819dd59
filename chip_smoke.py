#!/usr/bin/env python3
"""Smoke run of the solver's main paths on one GPU.

Every phase goes through the entry points a user calls, at the shapes of
the reference's own protocols, and checks its result against an
independent oracle.  Phases, in the order they run:

  gpu_tests  `pytest -m gpu` in a child process, run before this process
             touches JAX so that only one process ever holds the card
  device     JAX's first device is a GPU; nvidia-smi's name and power limit
  sync       does `jax.block_until_ready` wait for a long jitted chain?
  kernel     the Triton delta kernel at real widths against `_delta_ref`
  lp_batch   `solve_lp_batch` on 16 smoke LPs in the bench configuration,
             objectives against HiGHS; then the same instances with
             engine="steps", precision="f64"
  lp_scale   `abip.solve` on a dense 1000 x 10000 LP (density 0.3),
             residuals and gap in the original units
  conic      `solve_qcp_batch` on 16 dim-1020 mixed-cone programs, then
             `abip.solve` (the host-loop conic driver) on one of them;
             KKT certificates in the original units

Each phase prints one JSON line with its wall, iterations and worst
error beside its tolerance.  The solve phases take smaller sizes as
arguments, which the CPU tests use.  Any failed check exits non-zero, and so
does a process in which JAX finds no GPU.  The last line of a passing
run is {"ok": true, "device": {"platform", "kind", "count"}}.

    python chip_smoke.py            # one GPU, the phases above
    python chip_smoke.py --multi    # four GPUs: the sharded paths only
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
EPS = 1e-6


class PhaseFailed(Exception):
    pass


def report(phase, ok, **fields):
    print(json.dumps({"phase": phase, "ok": bool(ok), **fields},
                     default=float), flush=True)
    if not ok:
        raise PhaseFailed(phase)


def nvidia_smi():
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise PhaseFailed(f"device: nvidia-smi failed ({e})") from e
    if out.returncode != 0 or not out.stdout.strip():
        raise PhaseFailed("device: nvidia-smi found no GPU")
    return out.stdout.strip().splitlines()


# -- independent oracles ----------------------------------------------------

def cone_violation(x, cones=None):
    """Largest violation of x in K, relative to 1 + ||x||_inf: K is the
    nonnegative orthant (cones=None) or a ConeSpec laid out as soc
    blocks, rsoc blocks (2 t1 t2 >= ||z||^2), free, zero, nonneg."""
    x = np.asarray(x, np.float64)
    scale = 1.0 + np.abs(x).max()
    if cones is None:
        return max(0.0, -x.min()) / scale
    viol, pos = 0.0, 0
    for q in cones.soc:
        blk = x[pos:pos + q]
        viol = max(viol, np.linalg.norm(blk[1:]) - blk[0])
        pos += q
    for q in cones.rsoc:
        t1, t2, z = x[pos], x[pos + 1], x[pos + 2:pos + q]
        head = (t1 + t2) / np.sqrt(2.0)
        viol = max(viol, np.hypot((t1 - t2) / np.sqrt(2.0),
                                  np.linalg.norm(z)) - head)
        pos += q
    pos += cones.free
    viol = max(viol, np.abs(x[pos:pos + cones.zero]).max(initial=0.0))
    pos += cones.zero
    viol = max(viol, -x[pos:pos + cones.nonneg].min(initial=0.0))
    return max(0.0, viol) / scale


def kkt(A, b, c, x, y, s, cones=None):
    """Primal residual, dual residual and gap in the original units, by
    the reference's own norms -- 2-norms for LP (`abip-lp abip.c:458-535`),
    inf-norms for conic programs (`abip-qcp qcp_config.c:562-691`) --
    and the cone violations of x and s."""
    x, y, s = (np.asarray(v, np.float64) for v in (x, y, s))
    Ax, ATy = A @ x, A.T @ y
    pobj, dobj = float(c @ x), float(b @ y)
    if cones is None:
        norm = np.linalg.norm
        pres = norm(Ax - b) / (1 + norm(b))
        dres = norm(ATy + s - c) / (1 + norm(c))
        gap = abs(pobj - dobj) / (1 + abs(pobj) + abs(dobj))
    else:
        def norm(v):
            return np.abs(v).max()
        pres = norm(Ax - b) / (1 + max(norm(Ax), norm(b)))
        dres = norm(c - ATy - s) / (1 + norm(c))
        gap = abs(pobj - dobj) / (1 + max(abs(pobj), abs(dobj)))
    return {"pres": float(pres), "dres": float(dres), "gap": float(gap),
            "cone": max(cone_violation(x, cones), cone_violation(s, cones))}


def highs_objective(A, b, c):
    from scipy.optimize import linprog

    ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, None), method="highs")
    if ref.status != 0:
        raise PhaseFailed(f"HiGHS failed: {ref.message}")
    return float(ref.fun)


# -- phases -----------------------------------------------------------------

def phase_gpu_tests():
    t0 = time.perf_counter()
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "-q",
         "-p", "no:cacheprovider", "tests"],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=900)
    lines = proc.stdout.strip().splitlines()
    summary = lines[-1] if lines else ""
    ok = proc.returncode == 0 and "passed" in summary \
        and "skipped" not in summary
    if not ok:
        sys.stdout.write(proc.stdout[-4000:] + proc.stderr[-4000:])
    report("gpu_tests", ok, wall_sec=time.perf_counter() - t0,
           summary=summary)


def phase_device(smi, want_count):
    import jax

    devs = jax.devices()
    d = devs[0]
    for line in smi:
        print(line, flush=True)
    report("device", d.platform == "gpu" and len(devs) >= want_count,
           platform=d.platform, kind=d.device_kind, count=len(devs),
           jax=jax.__version__, nvidia_smi=smi[0])
    return d


def _closing_walls(fn, *args):
    """(dispatch, block_until_ready, value read) walls of one call."""
    import jax

    for _ in range(2):      # compile, and warm both closing paths
        jax.block_until_ready(fn(*args))
        jax.device_get(fn(*args))
    t0 = time.perf_counter()
    y = fn(*args)
    t_dispatch = time.perf_counter() - t0
    y.block_until_ready()
    t_bur = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.device_get(fn(*args))
    return t_dispatch, t_bur, time.perf_counter() - t0


def phase_sync():
    """Does block_until_ready wait?  A straight-line chain of large
    matmuls, reduced to one scalar, returns from dispatch long before
    the card is done; it is closed once by block_until_ready and once by
    a value read.  The check fails if block_until_ready returns early
    (its wall near the dispatch wall) or if the two closings disagree.
    The same work is also timed as a `fori_loop` (static trip count) and
    as a `while_loop` whose predicate reads the data, to show whether a
    jitted loop holds the host at dispatch."""
    import jax
    import jax.numpy as jnp

    f32 = jnp.float32
    w = jax.random.normal(jax.random.PRNGKey(0), (4096, 4096), f32) * 0.02
    x = jnp.ones((4096, 4096), f32)
    steps = 64

    @jax.jit
    def straight(x, w):
        for _ in range(steps):
            x = jnp.tanh(w @ x)
        return jnp.sum(x)

    @jax.jit
    def fori(x, w):
        return jnp.sum(jax.lax.fori_loop(
            0, steps, lambda i, x: jnp.tanh(w @ x), x))

    @jax.jit
    def data_while(x, w):
        def cond(c):
            return (c[0] < steps) & jnp.isfinite(c[1][0, 0])
        return jnp.sum(jax.lax.while_loop(
            cond, lambda c: (c[0] + 1, jnp.tanh(w @ c[1])), (0, x))[1])

    d, bur, read = _closing_walls(straight, x, w)
    loops = {}
    for name, fn in (("fori", fori), ("data_while", data_while)):
        ld, lbur, lread = _closing_walls(fn, x, w)
        loops[name] = {"dispatch_sec": ld, "block_until_ready_sec": lbur,
                       "value_read_sec": lread}
    ok = d <= 0.25 * bur and 0.8 * read <= bur <= 1.25 * read
    report("sync", ok, dispatch_sec=d, block_until_ready_sec=bur,
           value_read_sec=read, loops=loops,
           tolerance="dispatch <= 0.25 x block_until_ready, "
                     "block_until_ready within 0.8-1.25 x value read")


def _mid_solve_anchors(As, bs, cs, lam, thresh, qres, steps=300):
    """Anchors of a delta chunk taken mid-solve: f64 ADMM steps on the
    unscaled LPs from the cold start along mu = 1, 1e-2, 1e-4, then the
    chunk operands at barrier weight `lam`."""
    import jax
    import jax.numpy as jnp

    from abip.hsd import admm_update
    from abip.ops.admm_delta import delta_anchor

    f64 = jnp.float64
    rho_y, alpha = 1e-3, 1.8

    def one(A, b, c, th, q0):
        m, n = A.shape
        l = m + n + 1
        chol = jax.lax.linalg.cholesky(rho_y * jnp.eye(m, dtype=f64)
                                       + A @ A.T)

        def solve64(r):
            return jax.scipy.linalg.cho_solve((chol, True), r)

        h = jnp.concatenate([-b, c])
        g_y = solve64(h[:m] + A @ h[m:])
        g = jnp.concatenate([g_y, -(A.T @ g_y - h[m:])])
        g_th = jnp.dot(h, g)

        def step(mu, u, v):
            r = u + v
            q = jnp.concatenate([rho_y * r[:m], r[m:m + n]]) - r[l - 1] * h
            q = q - (jnp.dot(q, g) / (g_th + 1.0)) * h
            wx = -q[m:]
            z_y = solve64(q[:m] + A @ wx)
            z_x = A.T @ z_y - wx
            tau_t = r[l - 1] + jnp.dot(z_y, h[:m]) + jnp.dot(z_x, h[m:])
            u_t = jnp.concatenate([z_y, z_x, tau_t[None]])
            return admm_update(u, v, u, u_t, mu, alpha, m)

        u = jnp.concatenate([jnp.zeros((m,), f64), jnp.ones((l - m,), f64)])
        v = u
        for mu in (1.0, 1e-2, 1e-4):
            u, v = jax.lax.fori_loop(
                0, steps, lambda i, uv, mu=mu: step(mu, *uv), (u, v))
        z = jnp.zeros((l,), f64)
        return delta_anchor(A, solve64, h, g, g_th, rho_y, lam, alpha, th,
                            u, v, z, z, jnp.zeros((), jnp.int32), q0)

    return jax.jit(jax.vmap(one))(As, bs, cs, thresh, qres)


def _kernel_case(name, B, m, n, T, probe, seed):
    """Kernel vs the plain reference on B lanes of one shape: lanes cycle
    through a full chunk (thresh 0), a stop at the first probe (huge
    thresh) and an already-converged lane (zero trips)."""
    import jax
    import jax.numpy as jnp

    from abip.ops.admm_delta import _delta_kernel_call, _delta_ref
    from benchmarks.generate import smoke_lp

    data = [smoke_lp(m=m, n_rand=n - m, density=0.3, seed=seed + i)
            for i in range(B)]
    As, bs, cs = (jnp.asarray(np.stack(t)) for t in zip(*data))
    kind = np.arange(B) % 3
    thresh = np.where(kind == 1, 1e30, np.where(kind == 2, 1.0, 0.0))
    qres = np.where(kind == 2, 0.0, np.inf)
    anc = _mid_solve_anchors(As, bs, cs, 1e-5, jnp.asarray(thresh),
                             jnp.asarray(qres))
    kern = jax.jit(jax.vmap(lambda a: _delta_kernel_call(a, T, probe)))
    ref32 = jax.jit(jax.vmap(lambda a: _delta_ref(a, T, probe)))
    ref64 = jax.jit(jax.vmap(lambda a: _delta_ref(
        jax.tree.map(lambda x: x.astype(jnp.float64), a), T, probe)))
    compiled = kern.lower(anc).compile()
    mem = compiled.memory_analysis()
    out_k = jax.block_until_ready(compiled(anc))
    out_32 = jax.block_until_ready(ref32(anc))
    out_64 = jax.block_until_ready(ref64(anc))

    def err(a, b):
        return max(float(np.abs(np.asarray(x, np.float64) - np.asarray(y)).max()
                         / (1.0 + np.abs(np.asarray(y)).max()))
                   for x, y in zip(a, b))

    t_k = np.asarray(out_k[6])[:, 5].astype(int)
    t_64 = np.asarray(out_64[6])[:, 5].astype(int)
    want = np.where(kind == 0, T, np.where(kind == 1, probe, 0))
    e_k, e_32 = err(out_k, out_64), err(out_32, out_64)
    tol = max(4.0 * e_32, 1e-5)
    ok = (t_k == t_64).all() and (t_k == want).all() and e_k <= tol \
        and all(np.isfinite(np.asarray(o)).all() for o in out_k)
    report("kernel", ok, case=name, B=B, m=m, n=n, T=T,
           t_done=t_k.tolist(), err_kernel=e_k, err_xla_f32=e_32,
           tolerance=tol,
           memory_analysis=str(mem) if mem is not None else None)
    return anc, kern, ref32


def _time_chunks(anc, kern, ref32, T, reps=3):
    """Per-iteration device time of the kernel and of the plain XLA
    chunk on the same full-T anchors, in turns."""
    import jax
    import jax.numpy as jnp

    from abip.ops.admm_delta import _S_QINIT, _S_THRESH

    anc = anc._replace(scal=anc.scal.at[:, _S_THRESH].set(0.0)
                       .at[:, _S_QINIT].set(jnp.inf))
    walls = {"kernel": [], "xla": []}
    for name in ("kernel", "xla", "xla", "kernel") * reps:
        fn = kern if name == "kernel" else ref32
        jax.block_until_ready(fn(anc))
        t0 = time.perf_counter()
        jax.block_until_ready(fn(anc))
        walls[name].append(time.perf_counter() - t0)
    return {k: 1e6 * min(v) / T for k, v in walls.items()}


def phase_kernel():
    t0 = time.perf_counter()
    anc, kern, ref32 = _kernel_case("smoke_b16", 16, 50, 2000, 1536, 8, 0)
    us = _time_chunks(anc, kern, ref32, 1536)
    print(json.dumps({"phase": "kernel_timing", "B": 16, "m": 50,
                      "n": 2000, "T": 1536,
                      "us_per_iteration_kernel": us["kernel"],
                      "us_per_iteration_xla": us["xla"]}), flush=True)
    _kernel_case("lp500x5000_b1", 1, 500, 5000, 256, 8, 100)
    report("kernel", True, wall_sec=time.perf_counter() - t0)


def phase_lp_batch(B=16):
    import jax

    from abip.parallel.batched import solve_lp_batch
    from bench import HEADLINE, smoke_batch

    warm = smoke_batch(10_000, B)
    insts = smoke_batch(0, B)
    refs = [highs_objective(*(np.asarray(t[i]) for t in insts))
            for i in range(B)]
    for label, kw in (("delta_mixed", HEADLINE),
                      ("steps_f64", dict(HEADLINE, engine="steps",
                                         precision="f64"))):
        jax.block_until_ready(solve_lp_batch(*warm, **kw))
        t0 = time.perf_counter()
        r = jax.block_until_ready(solve_lp_batch(*insts, **kw))
        wall = time.perf_counter() - t0
        st = np.asarray(r.status)
        its = np.asarray(r.admm_iters)
        pobj = np.asarray(r.pobj)
        rel = np.abs(pobj - refs) / np.maximum(1.0, np.abs(refs))
        report("lp_batch", (st == 1).all() and rel.max() <= 1e-5,
               engine=kw["engine"], precision=kw["precision"],
               label=label, B=B, wall_sec=wall, solved=int((st == 1).sum()),
               admm_total=int(its.sum()), admm_max=int(its.max()),
               ipm_max=int(np.asarray(r.ipm_iters).max()),
               obj_rel_err_vs_highs=float(rel.max()), tolerance=1e-5)


def lp_scale_instance(m=1000, n=10000):
    from benchmarks.generate import smoke_lp

    return smoke_lp(m=m, n_rand=n - m, density=0.3, seed=0)


def phase_lp_scale(m=1000, n=10000):
    import abip

    A, b, c = lp_scale_instance(m, n)
    t0 = time.perf_counter()
    sol = abip.solve(A, b, c, eps=EPS)
    wall = time.perf_counter() - t0
    k = kkt(A, b, c, sol.x, sol.y, sol.s)
    report("lp_scale", sol.status_name == "Solved" and max(k.values()) <= EPS,
           m=m, n=n, wall_sec=wall, solve_sec=sol.solve_time,
           status=sol.status_name, ipm=sol.ipm_iters, admm=sol.admm_iters,
           **k, tolerance=EPS)
    return sol


def phase_conic(B=16, scale=5):
    import jax
    import jax.numpy as jnp

    from abip.parallel.batched_qcp import solve_qcp_batch
    from tools.conic_bench import family

    kw = dict(eps=EPS, precision="mixed", normalize=True, rho_y=1e-3,
              max_admm=1_000_000, solver="inverse", inner_crit_period=8)

    def batch(seed0):
        insts, cones = family(B, seed0=seed0, scale=scale)
        return insts, cones, [jnp.asarray(np.stack([t[j] for t in insts]))
                              for j in (1, 2, 3)]

    _, cones, warm = batch(8_000)
    jax.block_until_ready(solve_qcp_batch(*warm, None, cones=cones, **kw))
    insts, cones, arrs = batch(7_000)
    t0 = time.perf_counter()
    r = jax.block_until_ready(solve_qcp_batch(*arrs, None, cones=cones,
                                              **kw))
    wall = time.perf_counter() - t0
    st = np.asarray(r.status)
    worst = {"pres": 0.0, "dres": 0.0, "gap": 0.0, "cone": 0.0}
    for i, (_, A, b, c, _, _, _) in enumerate(insts):
        k = kkt(A, b, c, np.asarray(r.x[i]), np.asarray(r.y[i]),
                np.asarray(r.s[i]), cones)
        worst = {key: max(worst[key], k[key]) for key in worst}
    its = np.asarray(r.admm_iters)
    report("conic", (st == 1).all() and max(worst.values()) <= EPS,
           B=B, dim=cones.dim, m=cones.dim // 3, wall_sec=wall,
           solved=int((st == 1).sum()), admm_total=int(its.sum()),
           admm_max=int(its.max()), **worst, tolerance=EPS)

    # the host-loop conic driver (`abip.solve` -> `qcp.solve_qcp`) on the
    # first instance of the same family, compile included
    import abip

    _, A, b, c, _, _, _ = insts[0]
    t0 = time.perf_counter()
    sol = abip.solve(A, b, c, cones=cones, eps=EPS)
    wall = time.perf_counter() - t0
    k = kkt(A, b, c, sol.x, sol.y, sol.s, cones)
    report("conic_host", sol.status_name == "Solved"
           and max(k.values()) <= EPS, dim=cones.dim, wall_sec=wall,
           solve_sec=sol.solve_time, status=sol.status_name,
           ipm=sol.ipm_iters, admm=sol.admm_iters, **k, tolerance=EPS)


def phase_multi(B=16, m=1000, n=10000):
    """The sharded paths on four cards, each against its one-card run."""
    import jax
    from jax.sharding import Mesh

    import abip
    from abip.parallel.batched import solve_lp_batch
    from bench import HEADLINE, smoke_batch

    devs = jax.devices()
    mesh = Mesh(np.array(devs[:4]), ("batch",))
    insts = smoke_batch(0, B)
    one = jax.block_until_ready(solve_lp_batch(*insts, **HEADLINE))
    t0 = time.perf_counter()
    four = jax.block_until_ready(solve_lp_batch(*insts, mesh=mesh,
                                                **HEADLINE))
    wall = time.perf_counter() - t0
    owners = sorted({d.id for s in four.status.addressable_shards
                     for d in [s.device]})
    st1, st4 = np.asarray(one.status), np.asarray(four.status)
    k1, k4 = np.asarray(one.admm_iters), np.asarray(four.admm_iters)
    p1, p4 = np.asarray(one.pobj), np.asarray(four.pobj)
    rel = float((np.abs(p1 - p4) / np.maximum(1.0, np.abs(p1))).max())
    # each lane runs the same program on its own card; only the batch
    # width of XLA's batched f64 products differs (16 vs 4 lanes), which
    # may move the last bits, so counts may differ by a few percent and
    # objectives by the solve tolerance
    k_rel = float((np.abs(k1 - k4) / k1).max())
    report("multi_lp_batch", (st1 == st4).all() and (st4 == 1).all()
           and k_rel <= 0.02 and rel <= EPS and len(owners) == 4,
           wall_sec=wall, shard_devices=owners, status=st4.tolist(),
           admm_one=k1.tolist(), admm_four=k4.tolist(),
           admm_identical=bool((k1 == k4).all()),
           pobj_one=p1.tolist(), pobj_four=p4.tolist(),
           obj_rel_diff=rel, admm_rel_diff=k_rel,
           tolerance={"obj": EPS, "admm": 0.02})

    A, b, c = lp_scale_instance(m, n)
    ref = abip.solve(A, b, c, eps=EPS)
    rows = Mesh(np.array(devs[:4]), ("rows",))
    t0 = time.perf_counter()
    ws = abip.LPWorkspace(A, b, c, abip.Settings(eps=EPS))
    sol = ws.shard(rows, linsys="cg").solve()
    wall = time.perf_counter() - t0
    k = kkt(A, b, c, sol.x, sol.y, sol.s)
    rel = abs(sol.pobj - ref.pobj) / max(1.0, abs(ref.pobj))
    report("multi_lp_rows", sol.status_name == ref.status_name == "Solved"
           and max(k.values()) <= EPS and rel <= 1e-5,
           wall_sec=wall, status=sol.status_name, admm=sol.admm_iters,
           admm_one=ref.admm_iters, pobj=sol.pobj, pobj_one=ref.pobj,
           obj_rel_diff=rel, **k, tolerance=EPS)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the sharded paths, on four GPUs")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    try:
        smi = nvidia_smi()
        if not args.multi:
            phase_gpu_tests()
        want = 4 if args.multi else 1
        dev = phase_device(smi, want)
        import jax

        import abip  # noqa: F401  (x64 and f32 matmul precision)

        if args.multi:
            phase_multi()
        else:
            phase_sync()
            phase_kernel()
            phase_lp_batch()
            phase_lp_scale()
            phase_conic()
        count = len(jax.devices())
    except PhaseFailed as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
