"""Solver settings for ABIP.

A JAX re-design of the reference settings model
(`/root/reference/src/abip-lp/include/abip.h:36-79`,
`/root/reference/src/abip-qcp/include/abip.h:96-137`): one frozen dataclass
shared by the LP and conic drivers, hashable so it can ride through `jax.jit`
as a static argument.  Defaults follow the reference
(`src/abip-lp/include/glbopts.h:33-47`, `src/abip-lp/src/util.c:288-329`,
`src/abip-qcp/source/util.c:203-255`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


class Status:
    """Status codes, mirroring `src/abip-lp/include/glbopts.h:22-31`."""

    INFEASIBLE_INACCURATE = -7
    UNBOUNDED_INACCURATE = -6
    SIGINT = -5
    FAILED = -4
    INDETERMINATE = -3
    INFEASIBLE = -2
    UNBOUNDED = -1
    UNFINISHED = 0
    SOLVED = 1
    SOLVED_INACCURATE = 2

    _NAMES = {
        -7: "Infeasible/Inaccurate",
        -6: "Unbounded/Inaccurate",
        -5: "Interrupted",
        -4: "Failure",
        -3: "Indeterminate",
        -2: "Infeasible",
        -1: "Unbounded",
        0: "Unfinished",
        1: "Solved",
        2: "Solved/Inaccurate",
    }

    @classmethod
    def name(cls, code: int) -> str:
        return cls._NAMES.get(int(code), f"Unknown({code})")


@dataclasses.dataclass(frozen=True)
class Settings:
    """Unified solver settings.

    LP-specific and conic-specific knobs live side by side; each driver reads
    the subset it needs.  All fields are plain Python scalars so the dataclass
    is hashable and jit-static.
    """

    # -- termination ---------------------------------------------------------
    eps: float = 1e-3               # LP: single tolerance for pri/dual/gap
    eps_p: Optional[float] = None   # conic: primal tol (default: eps)
    eps_d: Optional[float] = None   # conic: dual tol (default: eps)
    eps_g: Optional[float] = None   # conic: gap tol (default: eps)
    eps_inf: Optional[float] = None  # infeasibility certificate tol
    eps_unb: Optional[float] = None  # unboundedness certificate tol
    max_ipm_iters: int = 500
    max_admm_iters: int = 1_000_000
    max_time: float = 3600.0        # seconds
    pfeasopt: bool = False          # accept primal-feasible-only (LP)
    err_dif: float = 0.0            # conic: stagnation exit (reference default 0 = off)

    # -- ADMM core -----------------------------------------------------------
    alpha: float = 1.8              # over-relaxation
    rho_y: float = 1e-3             # dual regularization (LP KKT)
    rho_x: float = 1.0              # conic DR weight on x block
    rho_tau: float = 1.0            # conic DR weight on tau
    half_update: bool = False
    psi: float = 1.0                # conic: inner tolerance exponent

    # -- scaling / normalization --------------------------------------------
    normalize: bool = True
    scale: float = 1.0
    pc_ruiz_rescale: bool = True
    origin_rescale: bool = False
    qp_rescale: bool = False
    ruiz_iter: int = 10

    # -- barrier schedule ----------------------------------------------------
    sparsity_ratio: float = 0.01
    hybrid_mu: bool = True
    hybrid_thresh: float = 1000.0
    dynamic_sigma: float = -1.0
    dynamic_sigma_second: float = 0.5
    dynamic_x: float = 0.8
    dynamic_eta: float = 1.1

    # -- restart & averaging -------------------------------------------------
    restart_fre: int = 1000
    restart_thresh: int = 100_000
    avg_criterion: bool = False
    # inner stopping-criterion cadence: 1 = every iteration (the reference
    # evaluates `iterate_Q_norm_resd` every iteration); P>1 checks every
    # P-th iteration (2 matvecs saved per skipped check, stage overrun at
    # most P-1 iterations)
    qres_period: int = 1

    # -- adaptive penalty (Barzilai-Borwein) ---------------------------------
    adaptive: bool = True
    eps_cor: float = 0.2
    eps_pen: float = 0.1
    adaptive_lookback: int = 20

    # -- linear system backend ----------------------------------------------
    linsys: str = "auto"            # auto | dense | cg
    dense_mode: str = "chol"        # chol | inverse_mixed (f32 explicit
    #   inverse apply + one f64 iterative-refinement step: one matmul
    #   instead of two sequential triangular solves)
    cg_rate: float = 2.0
    cg_max_iters: int = 1000
    cg_best_tol: float = 1e-9
    inner_check_period: int = 500   # conic: cadence of full residual checks

    # -- runtime -------------------------------------------------------------
    verbose: bool = False
    warm_start: bool = False
    dtype: str = "float64"

    def resolved(self) -> "Settings":
        """Fill conic tolerances that default to `eps`."""
        kw = {}
        for f in ("eps_p", "eps_d", "eps_g"):
            if getattr(self, f) is None:
                kw[f] = self.eps
        for f in ("eps_inf", "eps_unb"):
            if getattr(self, f) is None:
                kw[f] = self.eps
        return dataclasses.replace(self, **kw) if kw else self

    def validate(self) -> None:
        """Input validation, mirroring `src/abip-lp/src/abip.c:1646-1734`."""
        if self.max_ipm_iters <= 0:
            raise ValueError("max_ipm_iters must be positive")
        if self.max_admm_iters <= 0:
            raise ValueError("max_admm_iters must be positive")
        if self.eps <= 0:
            raise ValueError("eps tolerance must be positive")
        if not (0 < self.alpha < 2):
            raise ValueError("alpha must be in (0,2)")
        if self.rho_y <= 0:
            raise ValueError("rho_y must be positive")
        if self.scale <= 0:
            raise ValueError("scale must be positive")
        if self.eps_cor <= 0 or self.eps_pen <= 0:
            raise ValueError("eps_cor/eps_pen must be positive")
        if self.adaptive_lookback <= 0:
            raise ValueError("adaptive_lookback must be positive")
        if self.hybrid_mu and self.dynamic_sigma >= 0:
            raise ValueError(
                "when using the hybrid mu strategy, dynamic_sigma must be negative"
            )
        if self.qres_period < 1:
            raise ValueError("qres_period must be >= 1")
        if self.linsys not in ("auto", "dense", "cg"):
            raise ValueError(f"unknown linsys backend: {self.linsys!r}")
        if self.dense_mode not in ("chol", "inverse_mixed"):
            raise ValueError(f"unknown dense_mode: {self.dense_mode!r}")
