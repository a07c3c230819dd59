"""Schedule-parity tests: mu/sigma/gamma updates vs the tabulated C behavior.

Expected values are hand-transcribed from the reference listings
(`/root/reference/src/abip-lp/src/abip.c:753-921` tedious table,
`:930-977` LOQO, `:982-992` aggressive, `:2251-2277` hybrid dispatch) --
NOT read back from the implementation under test.
"""
import math

import numpy as np
import pytest

from abip.settings import Settings
from abip import schedules


def _stgs(**kw):
    return Settings(**kw).resolved()


def res_for(err_ratio, eps):
    """Residual dict whose max residual / eps == err_ratio."""
    return {
        "res_pri": err_ratio * eps,
        "res_dual": 0.0,
        "rel_gap": 0.0,
    }


# (ratio, expected_gamma_dense, expected_gamma_sparse) -- `abip.c:766-800`
# dense column and `:833-868` sparse column, before err_ratio multipliers.
GAMMA_TABLE = [
    (20.0, 2.0, 3.0),
    (5.0, 1.0, 1.0),
    (0.7, 0.9, 0.9),
    (0.3, 0.8, 0.8),
    (0.07, 0.7, 0.7),
    (0.03, 0.6, 0.6),
    (0.007, 0.5, 0.5),
    (0.003, 0.4, 0.4),
    (0.0005, 0.3, 0.3),
]


@pytest.mark.parametrize("ratio,g_dense,g_sparse", GAMMA_TABLE)
def test_gamma_table_parity(ratio, g_dense, g_sparse):
    eps = 1e-6
    stgs = _stgs(eps=eps)
    mu = ratio * eps
    # err_ratio > 10 falls into the keep-sigma else branch: gamma comes out
    # as the raw table value (`abip.c:826-829`, `:905-908`).
    res = res_for(100.0, eps)
    prev_sigma = 0.77
    # dense: sp > 0.4
    _, sig, g, fc, dc = schedules.update_mu_tedious(
        mu, prev_sigma, 9.9, res, stgs, 0.6, False, False)
    assert g == pytest.approx(g_dense)
    assert sig == prev_sigma
    assert not fc
    # sparse: sp <= 0.1 and sparsity_ratio <= 0.4 -> sparse branch
    stgs_sp = _stgs(eps=eps, sparsity_ratio=0.05)
    _, sig, g, fc, dc = schedules.update_mu_tedious(
        mu, prev_sigma, 9.9, res, stgs_sp, 0.05, False, False)
    assert g == pytest.approx(g_sparse)
    assert sig == prev_sigma


# (err_ratio, ratio, sigma, gamma_mult, final_check) -- dense branch,
# `abip.c:803-830`.
DENSE_ERR_CASES = [
    (8.0, 5.0, 0.5, 1.0, False),
    (5.0, 5.0, 0.6, 0.8, False),
    (2.0, 5.0, 0.7, 0.4, True),    # ratio >= 0.1 -> sigma 0.7
    (2.0, 0.05, 0.8, 0.4, True),   # ratio < 0.1 -> sigma 0.8
]


@pytest.mark.parametrize("err,ratio,sigma,gmul,fc_exp", DENSE_ERR_CASES)
def test_dense_err_ratio_parity(err, ratio, sigma, gmul, fc_exp):
    eps = 1e-6
    stgs = _stgs(eps=eps)
    mu = ratio * eps
    base_g = schedules._gamma_table(ratio, dense=True)
    mu2, sig, g, fc, dc = schedules.update_mu_tedious(
        mu, 0.77, 9.9, res_for(err, eps), stgs, 0.6, False, False)
    assert sig == pytest.approx(sigma)
    assert g == pytest.approx(base_g * gmul)
    assert fc == fc_exp
    assert mu2 == pytest.approx(mu * sigma)


# (err_ratio, ratio, double_check_in, sigma, gamma_mult, final_check,
#  double_check_out) -- sparse branch, `abip.c:871-909`.
SPARSE_ERR_CASES = [
    (8.0, 5.0, False, 0.82, 0.8, False, False),
    (5.0, 5.0, False, 0.84, 0.6, False, False),
    (3.5, 5.0, False, 0.85, 0.5, True, False),
    (2.0, 5.0, False, 0.88, 0.4, True, False),   # ratio >= 0.1
    (2.0, 0.05, True, 0.9, 0.4, True, False),    # ratio < 0.1, double_check
    (2.0, 0.05, False, 1.0, 0.1, True, True),    # ratio < 0.1, first pass
]


@pytest.mark.parametrize(
    "err,ratio,dc_in,sigma,gmul,fc_exp,dc_exp", SPARSE_ERR_CASES)
def test_sparse_err_ratio_parity(err, ratio, dc_in, sigma, gmul, fc_exp,
                                 dc_exp):
    eps = 1e-6
    stgs = _stgs(eps=eps, sparsity_ratio=0.05)
    mu = ratio * eps
    base_g = schedules._gamma_table(ratio, dense=False)
    mu2, sig, g, fc, dc = schedules.update_mu_tedious(
        mu, 0.77, 9.9, res_for(err, eps), stgs, 0.05, False, dc_in)
    assert sig == pytest.approx(sigma)
    assert g == pytest.approx(base_g * gmul)
    assert fc == fc_exp
    assert dc == dc_exp
    assert mu2 == pytest.approx(mu * sigma)


def test_aggressive_uses_dynamic_sigma_exponent():
    """`abip.c:988-990`: eta = stgs->dynamic_sigma (the mutable one), NOT
    the parsed-but-unused dynamic_eta setting."""
    stgs = _stgs(dynamic_x=0.8, dynamic_eta=1.1)
    mu = 0.01
    # dynamic_sigma = -1: mu^-1 = 100 > x*mu -> mu *= 0.8*mu
    assert schedules.update_mu_aggressive(mu, stgs, -1.0) == pytest.approx(
        mu * 0.8 * mu)
    # a hypothetical positive exponent routes through pow(mu, eta)
    assert schedules.update_mu_aggressive(mu, stgs, 2.0) == pytest.approx(
        mu * min(0.8 * mu, mu ** 2.0))


def test_loqo_rule_parity():
    """`abip.c:930-977`: ksi = min(xs)/mean(xs);
    sigma = max(0.1*min(0.05(1-ksi)/ksi, 2)^3, shrink)."""
    m = 2
    u = np.array([1.0, 1.0, 0.5, 2.0, 1.0])
    v = np.array([0.0, 0.0, 0.2, 0.3, 0.4])
    xs = u[m:] * v[m:]
    ksi = xs.min() / xs.mean()
    sigma = min(0.05 * (1 - ksi) / ksi, 2.0)
    sigma = max(0.1 * sigma ** 3, 0.5)
    mu = 0.37
    got = schedules.update_mu_loqo(mu, u, v, m, 0.5)
    assert got == pytest.approx(mu * sigma)


def test_hybrid_dispatch_parity():
    """`abip.c:2251-2277`: aggressive while mu >= hybrid_thresh*eps (with
    dynamic_sigma < 0), LOQO after the threshold when
    dynamic_sigma_second > 0."""
    eps = 1e-6
    stgs = _stgs(eps=eps, hybrid_mu=True)
    u = np.array([1.0, 0.5, 2.0, 1.0])
    v = np.array([0.0, 0.2, 0.3, 0.4])

    # above threshold: aggressive fires with the current dynamic_sigma
    mu = 1.0
    out = schedules.update_mu(mu, 0.8, 1.0, res_for(100, eps), stgs, 0.6,
                              False, False, -1.0, u=u, v=v, m=1)
    expect = mu * min(stgs.dynamic_x * mu, math.pow(mu, -1.0))
    assert out[0] == pytest.approx(expect)
    assert out[5] == -1.0

    # below threshold with dynamic_sigma_second > 0: LOQO, and
    # dynamic_sigma is overwritten by dynamic_sigma_second
    mu = 0.5 * stgs.hybrid_thresh * eps
    out = schedules.update_mu(mu, 0.8, 1.0, res_for(100, eps), stgs, 0.6,
                              False, False, -1.0, u=u, v=v, m=1)
    assert out[5] == stgs.dynamic_sigma_second
    assert out[0] == pytest.approx(
        schedules.update_mu_loqo(mu, u, v, 1, stgs.dynamic_sigma_second))
