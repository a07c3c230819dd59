"""Iteration logging and phase accounting.

Mirrors the reference's observability surface (SURVEY.md section 5.1/5.5):
the fixed-column iteration table (`print_summary`,
`src/abip-lp/src/abip.c:1418-1463`, header `:17-21`), the status footer
with error metrics and certificates (`print_footer`), and the per-phase
wall-clock accounting the QCP side prints at exit
(`source/abip.c:1083-1093,1196-1201`).
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Optional


class PhaseTimers:
    """Accumulating wall-clock timers keyed by phase name.

    Equivalent of the reference's lin/barrier/res/check/update timers
    (`source/abip.c:1083-1093`)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def add(self, name: str, seconds: float, count: int = 1):
        self.totals[name] += seconds
        self.counts[name] += count

    def summary(self) -> str:
        lines = ["Phase timing:"]
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(
                f"  {name:<22s} {tot:9.3f}s  ({n} calls, {tot / max(n, 1) * 1e3:8.3f} ms avg)"
            )
        return "\n".join(lines)


_COLUMNS = [
    ("ipm", 5), ("admm", 8), ("mu", 9), ("pres", 9), ("dres", 9),
    ("gap", 9), ("pobj", 11), ("dobj", 11), ("tau", 8), ("time(s)", 8),
]


class IterationLog:
    """Fixed-column progress table (reference `HEADER`, `abip.c:17-21`)."""

    def __init__(self, enabled: bool = True, print_fn=print):
        self.enabled = enabled
        self.print_fn = print_fn
        self._header_printed = False
        self.t0 = time.perf_counter()

    def header(self):
        if not self.enabled or self._header_printed:
            return
        line = "|".join(f"{name:>{w}s}" for name, w in _COLUMNS)
        rule = "-" * len(line)
        self.print_fn(rule)
        self.print_fn(line)
        self.print_fn(rule)
        self._header_printed = True

    def row(self, ipm: int, admm: int, mu: float, res: dict,
            pobj: float = float("nan"), dobj: float = float("nan")):
        if not self.enabled:
            return
        self.header()
        vals = [
            f"{ipm:>5d}", f"{admm:>8d}", f"{mu:>9.2e}",
            f"{res.get('res_pri', float('nan')):>9.2e}",
            f"{res.get('res_dual', float('nan')):>9.2e}",
            f"{res.get('rel_gap', float('nan')):>9.2e}",
            f"{pobj:>11.3e}", f"{dobj:>11.3e}",
            f"{res.get('tau', float('nan')):>8.2e}",
            f"{time.perf_counter() - self.t0:>8.2f}",
        ]
        self.print_fn("|".join(vals))

    def footer(self, status_name: str, info: dict,
               timers: Optional[PhaseTimers] = None):
        if not self.enabled:
            return
        self.print_fn("-" * 40)
        self.print_fn(f"Status: {status_name}")
        for key in ("pobj", "dobj", "res_pri", "res_dual", "rel_gap",
                    "ipm_iters", "admm_iters", "setup_time", "solve_time",
                    "avg_cg_iters"):
            if key in info:
                v = info[key]
                self.print_fn(f"  {key:<14s} {v:.6g}" if isinstance(v, float)
                              else f"  {key:<14s} {v}")
        if timers is not None:
            self.print_fn(timers.summary())
        self.print_fn("=" * 40)


def solver_banner(kind: str, m: int, n: int, nnz: int, backend: str) -> str:
    """Init header (`print_init_header`)."""
    return (
        f"ABIP {kind}: variables n = {n}, constraints m = {m}, "
        f"nnz(A) = {nnz}\nlinear system backend: {backend}"
    )
