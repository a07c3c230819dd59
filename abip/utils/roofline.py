"""Per-iteration cost model and speed-of-light estimate.

The reference reports a per-ADMM-iteration cost summary (avg linsys
solve time, nnz in the factor — `src/abip-lp/linsys/direct.c:15-26`).
The device analogue is a roofline: each ADMM iteration streams the
problem matrix a fixed number of times and does a fixed flop count, so
peak memory bandwidth (the usual bound -- these matvecs do ~0.5 flop
per byte) implies a hardware iteration-rate ceiling.  `bench.py`
reports measured/ceiling so regressions in the hot loop show up as a
falling fraction, independent of problem size.
"""
from __future__ import annotations

from dataclasses import dataclass

# Published peaks keyed by JAX's `device_kind`.  H100 SXM: NVIDIA H100
# Tensor Core GPU data sheet -- 3.35 TB/s HBM3, 67 TFLOP/s f32 and
# 34 TFLOP/s f64 outside the tensor cores, at the 700 W power limit.
DEVICES = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0, "f32_tflops": 67.0,
                              "f64_tflops": 34.0},
}


def device_peaks(device_kind: str) -> dict:
    """Peak table entry for `device_kind`; an unknown device is an
    error, never a default."""
    try:
        return DEVICES[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind "
                       f"{device_kind!r}; add it to roofline.DEVICES "
                       f"with its source") from None


def _ceilings(bytes_moved, flops, itemsize, device_kind):
    spec = device_peaks(device_kind)
    fl = spec["f64_tflops" if itemsize == 8.0 else "f32_tflops"] * 1e12
    return IterationCost(
        bytes_moved=bytes_moved, flops=flops,
        ceiling_iters_per_sec_bw=spec["hbm_gbps"] * 1e9 / bytes_moved,
        ceiling_iters_per_sec_flops=fl / flops,
    )


@dataclass
class IterationCost:
    bytes_moved: float           # per ADMM iteration
    flops: float
    ceiling_iters_per_sec_bw: float
    ceiling_iters_per_sec_flops: float

    @property
    def ceiling_iters_per_sec(self) -> float:
        return min(self.ceiling_iters_per_sec_bw,
                   self.ceiling_iters_per_sec_flops)


def lp_iteration_cost(m: int, n: int, precision: str = "mixed",
                      qres_period: int = 1, avg_period: int = 10, *,
                      device_kind: str) -> IterationCost:
    """Cost of one dense-path ADMM iteration of `device_solve_lp`.

    Counts the dominant terms: the projection streams A twice (forward
    + transpose apply) and the inner criterion streams it twice every
    `qres_period`-th iteration; the KKT apply is an m x m matmul-vector;
    vector work is O(m + n) and negligible against A for n >> m.
    """
    import math

    itemsize = 4.0 if precision in ("mixed", "f32") else 8.0
    a_bytes = itemsize * m * n
    # streams of A per iteration: 2 for the projection, plus the inner
    # criterion (2) whenever (j % qres_period == 0) OR
    # (j % avg_period == 0) -- the solver always evaluates the averaged
    # candidate every avg_period-th iteration -- plus the averaged-
    # candidate criterion (2) and the residual check (2) on the
    # every-avg_period-th iterations
    P = max(1, qres_period)
    Pa = max(1, avg_period)
    freq_a = 1.0 / Pa
    freq_q = 1.0 / P + freq_a - 1.0 / math.lcm(P, Pa)
    streams = 2.0 + 2.0 * freq_q + (2.0 + 2.0) * freq_a
    bytes_moved = streams * a_bytes + itemsize * (m * m)   # + KKT apply
    flops = streams * 2.0 * m * n + 2.0 * m * m
    return _ceilings(bytes_moved, flops, itemsize, device_kind)


def qcp_iteration_cost(m: int, n: int, precision: str = "mixed",
                       inner_crit_period: int = 1, form: str = "auto", *,
                       device_kind: str) -> IterationCost:
    """Cost of one ADMM iteration of the conic device route
    (`solve_qcp_device`), the conic analogue of `lp_iteration_cost`
    (reference per-iteration report: `source/linsys.c:71-97`).

    Dominant terms: the DR projection streams A twice and applies the
    cached Schur inverse (k x k, k = m under the Woodbury dual form when
    2m <= n with diagonal H, else n); the HSD inner convergence check
    streams A twice every `inner_crit_period`-th iteration; the cone
    prox is O(n) segment work and negligible.
    """
    itemsize = 4.0 if precision in ("mixed", "f32") else 8.0
    a_bytes = itemsize * m * n
    k = m if (form == "dual" or (form == "auto" and 2 * m <= n)) else n
    P = max(1, inner_crit_period)
    streams = 2.0 + 2.0 / P
    bytes_moved = streams * a_bytes + itemsize * (k * k)
    flops = streams * 2.0 * m * n + 2.0 * k * k
    return _ceilings(bytes_moved, flops, itemsize, device_kind)
