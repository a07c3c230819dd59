"""Benchmark harness: prints ONE JSON line with the headline metric.

Headline: aggregate ADMM iterations/second over a B=16 batch of
reference-smoke-shape LPs (`test/test_abip_install.m:7-21` of the
reference: m=50, n=2000, density=0.3), solved to eps=1e-6 by
`solve_lp_batch` in the HEADLINE configuration.  `vs_baseline` divides
by the single-thread reference C solver rate (BASELINE_MEASURED.json,
tools/reference_baseline_driver.c).

A warm-up batch compiles; then each of N rounds solves FRESH instances
and is closed by `jax.block_until_ready`; the median valid round is
reported with every round's rate.

The run needs a GPU and exits non-zero without one.  ABIP_BENCH_CPU=1
is a rehearsal of the same path on the CPU, labelled "cpu".

Env knobs: ABIP_BENCH_CPU=1, ABIP_BENCH_B (batch size),
ABIP_BENCH_ROUNDS, ABIP_BENCH_ENGINE, ABIP_BENCH_PRECISION,
ABIP_BENCH_SOLVER, ABIP_BENCH_QRES, ABIP_BENCH_AVG, ABIP_BENCH_REF_SRC
(reference abip-lp sources, for the same-instance reference wall).
"""
import json
import os
import sys
import time

import numpy as np

# The headline solve configuration: anchored mixed precision with the
# delta engine, explicit-inverse KKT apply, inner-criterion chunks of
# 1536 iterations and the averaged candidate every 20th.  These values
# were tuned on an earlier accelerator; re-tuning them on the GPU is
# ROADMAP Speed item 5.
HEADLINE = dict(eps=1e-6, max_ipm=200, max_admm=200_000, solver="inverse",
                qres_period=1536, avg_period=20, precision="mixed",
                engine="delta")


def reference_smoke_lp(m=50, n_rand=1950, density=0.3, seed=0):
    """Random degenerate-free LP, the shape of `test_abip_install.m:7-21`:
    A = [sprand(m, n_rand, density), I_m], b = A x0, c = A' y0 + s0."""
    rng = np.random.default_rng(seed)
    Ar = rng.standard_normal((m, n_rand)) * (rng.random((m, n_rand)) < density)
    A = np.concatenate([Ar, np.eye(m)], axis=1)
    n = n_rand + m
    x0 = rng.random(n) + 0.5
    y0 = rng.standard_normal(m)
    s0 = rng.random(n) + 0.5
    b = A @ x0
    c = A.T @ y0 + s0
    return A, b, c


def smoke_batch(seed0, B):
    """Instances seed0 .. seed0+B-1, stacked on the default device."""
    import jax.numpy as jnp

    data = [reference_smoke_lp(seed=seed0 + i) for i in range(B)]
    return tuple(jnp.asarray(np.stack(t)) for t in zip(*data))


def _load_baseline():
    path = os.path.join(os.path.dirname(__file__), "BASELINE_MEASURED.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f).get("admm_iters_per_sec_reference")
    return None


def _reference_binary():
    """Path to the reference parity binary (file-driven abip-lp direct
    solve), built on first use from the reference's abip-lp sources in
    the directory ABIP_BENCH_REF_SRC names.

    The solved-instance draws vary ~4x in difficulty (per-lane q=1
    counts 2k-9k on the smoke shape), so dividing our instance rate by
    the reference's rate on its OWN fixed draw (1993 admm iters) is
    apples-to-oranges.  The honest ratio times the reference binary on
    the SAME instances the batch solved.  Returns None when the
    reference sources or a C compiler are unavailable (the ratio is then
    simply omitted)."""
    R = os.environ.get("ABIP_BENCH_REF_SRC")
    if not R:
        return None
    # cache under the repo, not a fixed world-writable /tmp path: a
    # pre-planted /tmp/refbench/refparity would otherwise be executed
    # as-is (advisor finding, round 3)
    cache_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             ".refbench")
    binpath = os.path.join(cache_dir, "refparity")
    if os.path.exists(binpath):
        return binpath
    drv = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "tools", "reference_baseline_driver.c")
    if not (os.path.isdir(R) and os.path.exists(drv)):
        return None
    import glob
    import subprocess

    os.makedirs(cache_dir, exist_ok=True)
    srcs = [drv] + [
        f"{R}/src/{s}.c" for s in
        ("abip", "adaptive", "cs", "ctrlc", "linalg", "normalize", "util")
    ] + [f"{R}/linsys/common.c", f"{R}/linsys/direct.c"] + \
        glob.glob(f"{R}/external/amd/*.c") + [
        f"{R}/external/ldl/ldl.c", f"{R}/external/SuiteSparse_config.c"]
    cmd = ["gcc", "-O3", "-march=native", "-DNDEBUG", "-DPARITY_MAIN",
           "-o", binpath] + srcs + [
        f"-I{R}/include", f"-I{R}/linsys", f"-I{R}/external",
        f"-I{R}/external/amd", f"-I{R}/external/ldl", "-lm"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except Exception:  # noqa: BLE001 -- ratio is optional context
        return None
    return binpath if os.path.exists(binpath) else None


def _reference_same_instances(seed0, B, eps=1e-6):
    """Serial reference wall on the SAME instances as smoke_batch(seed0, B).

    Returns {"wall_sec", "mean_admm", "solved"} or None if the binary is
    unavailable or any run fails."""
    import struct
    import subprocess
    import tempfile

    binpath = _reference_binary()
    if binpath is None:
        return None
    import scipy.sparse as sp

    wall, iters, solved = 0.0, 0, 0
    for i in range(B):
        A, b, c = reference_smoke_lp(seed=seed0 + i)
        Asp = sp.csc_matrix(A)
        fd, path = tempfile.mkstemp(suffix=".bin")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(struct.pack("<3q", *Asp.shape, Asp.nnz))
                f.write(np.asarray(Asp.indptr, "<i8").tobytes())
                f.write(np.asarray(Asp.indices, "<i8").tobytes())
                f.write(np.asarray(Asp.data, "<f8").tobytes())
                f.write(np.asarray(b, "<f8").tobytes())
                f.write(np.asarray(c, "<f8").tobytes())
            out = subprocess.run([binpath, path, f"{eps:g}"],
                                 capture_output=True, text=True,
                                 timeout=600)
            rec = json.loads(out.stdout.strip().splitlines()[-1])
        except Exception:  # noqa: BLE001 -- ratio is optional context
            return None
        finally:
            os.unlink(path)
        wall += rec["time_sec"]
        iters += rec["admm"]
        solved += rec["status"] == "Solved"
    return {"wall_sec": round(wall, 3), "mean_admm": round(iters / B, 1),
            "solved": solved}


def _load_baseline_instances_per_sec():
    """Reference solved-instance rate on the smoke shape: 1 instance per
    median solve wall (single-thread direct backend) -- the metric a
    user feels; `vs_baseline_instances` divides by it."""
    path = os.path.join(os.path.dirname(__file__), "BASELINE_MEASURED.json")
    if os.path.exists(path):
        with open(path) as f:
            t = json.load(f).get("reference_time_sec_median")
        if t:
            return 1.0 / t
    return None


def _median_pick(cands, rate_of, valid_of):
    """Median-of-valid-rounds selection.  Returns (chosen_cand,
    rounds_detail): the chosen round is the median-rate round among
    VALID rounds (all lanes solved); if no round is fully valid, the
    median among all rounds (its solved count then exposes the
    failure).  With an even count the LOWER middle is reported.  Every
    round's rate/wall/validity is recorded in rounds_detail so the
    spread is visible."""
    detail = [{"rate": round(rate_of(c), 1),
               "wall_sec": round(c[1], 4),
               "valid": bool(valid_of(c))} for c in cands]
    pool = [c for c in cands if valid_of(c)] or cands
    pool = sorted(pool, key=rate_of)
    chosen = pool[(len(pool) - 1) // 2]
    return chosen, detail


def _speed_of_light(shape, kw, B, device_kind):
    """Roofline ceiling for the current config (`abip/utils/roofline.py`):
    the measured/ceiling fraction is the per-iteration cost report
    (`direct.c:15-26` analogue)."""
    from abip.utils.roofline import lp_iteration_cost

    c = lp_iteration_cost(shape[0], shape[1],
                          precision=kw.get("precision", "mixed"),
                          qres_period=kw.get("qres_period", 1),
                          avg_period=kw.get("avg_period", 10),
                          device_kind=device_kind)
    return {
        "sol_iters_per_sec": round(B * c.ceiling_iters_per_sec, 1),
        "sol_device_kind": device_kind,
        "iter_bytes": int(c.bytes_moved),
    }


def main():
    import jax

    if os.environ.get("ABIP_BENCH_CPU"):
        jax.config.update("jax_platforms", "cpu")
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not os.environ.get("ABIP_BENCH_CPU"):
        print(f"bench.py needs a GPU; JAX found {dev.platform!r} "
              "(ABIP_BENCH_CPU=1 runs the CPU rehearsal)", file=sys.stderr)
        return 2
    import abip  # noqa: F401  (enables x64)
    from abip.parallel.batched import solve_lp_batch

    kw = dict(HEADLINE)
    kw["solver"] = os.environ.get("ABIP_BENCH_SOLVER", kw["solver"])
    kw["qres_period"] = int(os.environ.get("ABIP_BENCH_QRES",
                                           kw["qres_period"]))
    kw["avg_period"] = int(os.environ.get("ABIP_BENCH_AVG",
                                          kw["avg_period"]))
    kw["engine"] = os.environ.get("ABIP_BENCH_ENGINE", kw["engine"])
    kw["precision"] = os.environ.get("ABIP_BENCH_PRECISION",
                                     kw["precision"])
    B = int(os.environ.get("ABIP_BENCH_B", "16"))
    jax.block_until_ready(solve_lp_batch(*smoke_batch(10_000, B), **kw))

    rounds = int(os.environ.get("ABIP_BENCH_ROUNDS", "5"))
    cands = []
    for r_i in range(rounds):
        seed0 = r_i * B
        timed = jax.block_until_ready(smoke_batch(seed0, B))
        t0 = time.perf_counter()
        res = jax.block_until_ready(solve_lp_batch(*timed, **kw))
        dt = time.perf_counter() - t0
        cands.append((np.asarray(res.admm_iters), dt, res, seed0))
    chosen, rounds_detail = _median_pick(
        cands,
        rate_of=lambda c: float(c[0].sum()) / c[1],
        valid_of=lambda c: bool((np.asarray(c[2].status) == 1).all()))
    its, dt, res, seed0 = chosen
    st = np.asarray(res.status)
    agg = float(its.sum()) / dt
    base = _load_baseline()
    inst_base = _load_baseline_instances_per_sec()
    ref_same = _reference_same_instances(seed0, B)
    sol = (_speed_of_light((50, 2000), kw, B, dev.device_kind)
           if dev.platform == "gpu" else {})
    out = {
        "metric": "admm_iters_per_sec",
        "value": round(agg, 1),
        "unit": "iter/s",
        "vs_baseline": round(agg / base, 3) if base else None,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "detail": {
            "mode": f"batched B={B} {kw['precision']} "
                    f"engine={kw['engine']} (aggregate, median of "
                    f"{len(rounds_detail)} rounds)",
            "problem": "smoke_lp m=50 n=2000 density=0.3",
            "rounds": rounds_detail,
            "eps": kw["eps"],
            "solved": int((st == 1).sum()),
            "total_admm_iters": int(its.sum()),
            "mean_admm_iters": float(its.mean()),
            "batch_wall_sec": round(dt, 4),
            "instances_per_sec": round(B / dt, 2),
            "vs_baseline_instances": (round((B / dt) / inst_base, 3)
                                      if inst_base else None),
            **({"ref_same_instances_wall_sec": ref_same["wall_sec"],
                "ref_same_instances_mean_admm": ref_same["mean_admm"],
                "ref_same_instances_solved": ref_same["solved"],
                "vs_reference_same_instances":
                    round(ref_same["wall_sec"] / dt, 2)}
               if ref_same else {}),
            "baseline": "reference abip-lp direct, 1 thread "
                        "(BASELINE_MEASURED.json)",
            "rel_gap_max": float(np.asarray(res.rel_gap).max()),
            **sol,
        },
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
