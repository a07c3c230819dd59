"""Application problem reformulations: LASSO, SVM (SOCP and QP forms).

JAX analogue of the reference's per-problem configs
(`/root/reference/src/abip-qcp/source/{lasso,svm,svm_qp}_config.c`): each
`*_to_conic` builds the conic embedding (cones + constraint data +
recovery map) that the reference assembles inside its `init_*` functions
and the ML MEX layer (`mex/abip_ml_mex.c:320-346`), keeping reformulation
and cone metadata in one place (SURVEY.md section 2.6).
"""
from .lasso import lasso_to_conic, solve_lasso
from .svm import svm_to_conic_qp, svm_to_conic_socp, solve_svm

__all__ = [
    "lasso_to_conic",
    "solve_lasso",
    "svm_to_conic_qp",
    "svm_to_conic_socp",
    "solve_svm",
]
