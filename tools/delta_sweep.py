"""Delta chunk on the GPU: Triton kernel vs plain XLA over lane shapes.

For each (B, m, n) it builds B mid-solve anchors of smoke LPs, runs one
T-iteration chunk with every lane running the full chunk, and times the
Triton kernel (`_delta_kernel_call`) against `_delta_ref` under XLA in
the order kernel, xla, xla, kernel.  Each line gives the kernel's block
shapes (`kernel_config`), its row-tile trips per matrix pass, the us
per iteration of each variant and which one `use_kernel` picks.  `--bm` / `--warps` force the kernel's
row-tile height / warp count (the block-shape sweep behind
`kernel_config`).  The last line names the card and its power limit.
Needs a GPU.

    python tools/delta_sweep.py                     # the default shapes
    python tools/delta_sweep.py --shapes 16x50x2000 64x50x2000 [--T 1536]
    python tools/delta_sweep.py --shapes 16x50x2000 --bm 2 4 8 16
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from unittest import mock

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEFAULT_SHAPES = (
    "16x50x2000", "16x60x2000", "16x70x2000", "16x80x2000", "16x100x2000",
    "16x100x1000", "16x150x1000", "16x200x1000", "16x120x500",
    "16x250x500", "16x50x2600", "16x30x4000", "16x16x8000",
    "1x50x2000", "64x50x2000", "128x50x2000", "1x500x5000",
)


def sweep_one(B, m, n, T, probe=8, seed=0, bm=None, warps=None):
    import jax
    import jax.numpy as jnp

    from abip.ops import admm_delta
    from benchmarks.generate import smoke_lp
    from chip_smoke import _mid_solve_anchors, _time_chunks

    data = [smoke_lp(m=m, n_rand=n - m, density=0.3, seed=seed + i)
            for i in range(B)]
    As, bs, cs = (jnp.asarray(np.stack(t)) for t in zip(*data))
    anc = _mid_solve_anchors(As, bs, cs, 1e-5, jnp.zeros((B,)),
                             jnp.full((B,), jnp.inf), steps=20)
    MP, NP, bm0, nw0 = admm_delta.kernel_config(m, n)
    bm, nw = bm or bm0, warps or nw0
    kern = jax.jit(jax.vmap(
        lambda a: admm_delta._delta_kernel_call(a, T, probe)))
    ref32 = jax.jit(jax.vmap(lambda a: admm_delta._delta_ref(a, T, probe)))
    with mock.patch.object(admm_delta, "kernel_config",
                           lambda m, n: (MP, NP, bm, nw)):
        us = _time_chunks(anc, kern, ref32, T)
    trips = -(-m // bm)
    return {"B": B, "m": m, "n": n, "T": T, "MP": MP, "NP": NP, "bm": bm,
            "num_warps": nw, "trips": trips,
            "us_per_iteration_kernel": us["kernel"],
            "us_per_iteration_xla": us["xla"],
            "faster": "kernel" if us["kernel"] < us["xla"] else "xla",
            "use_kernel": admm_delta.use_kernel(m, n)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", nargs="+", default=DEFAULT_SHAPES,
                    help="lane shapes as BxMxN")
    ap.add_argument("--T", type=int, default=1536)
    ap.add_argument("--bm", type=int, nargs="+", default=[None],
                    help="force the kernel's row-tile height")
    ap.add_argument("--warps", type=int, default=None,
                    help="force the kernel's warp count")
    args = ap.parse_args(argv)

    import jax

    if jax.devices()[0].platform != "gpu":
        print("delta_sweep.py needs a GPU", file=sys.stderr)
        return 2
    import abip  # noqa: F401  (x64 and f32 matmul precision)

    for shape in args.shapes:
        B, m, n = (int(k) for k in shape.split("x"))
        for bm in args.bm:
            print(json.dumps(sweep_one(B, m, n, args.T, bm=bm,
                                       warps=args.warps)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"summary": "delta_sweep",
                      "device_kind": jax.devices()[0].device_kind,
                      "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
