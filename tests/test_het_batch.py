"""Heterogeneous-cone batched conic solves (`PaddedConeLayout`).

The reference's CBLIB protocol runs mixed cone structures one process
per instance (`scripts/bench-qcp/test_cblib.m:60-76`); `solve_qcp_het_
batch` solves the whole mixed suite in ONE vmapped program with the
cone layout as lane data.  Parity oracle: the single-instance device
route (`solve_qcp_device`) on each lane's natural shapes.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from abip.cones import ConeLayout, ConeSpec, PaddedConeLayout
from abip.parallel.batched_qcp import (pad_conic_instances,
                                           solve_qcp_het_batch)


def _mini_problems(k=None):
    from benchmarks.conic_mini import instances

    out = [(A, b, c, None, spec)
           for (_n, A, b, c, spec, _p) in instances()]
    return out if k is None else out[:k]


def test_pad_conic_instances_shapes():
    probs = _mini_problems()
    As, bs, cs, Qs, layout, dims = pad_conic_instances(probs)
    B = len(probs)
    m_pad = max(m for m, _ in dims)
    n_pad = max(n for _, n in dims)
    assert As.shape == (B, m_pad, n_pad)
    assert bs.shape == (B, m_pad) and cs.shape == (B, n_pad)
    assert Qs is None
    assert layout.kind.shape == (B, n_pad)
    assert layout.n == n_pad
    # padded slots are zero-cone elements; each lane's prefix matches
    # its natural layout
    for k, (_A, _b, _c, _Q, spec) in enumerate(probs):
        lay = ConeLayout(spec)
        np.testing.assert_array_equal(np.asarray(layout.kind)[k, : lay.n],
                                      lay.kind)
        from abip.cones import _ZERO
        assert (np.asarray(layout.kind)[k, lay.n:] == _ZERO).all()


def test_padded_layout_prox_matches_natural():
    """cone_barrier_prox through a padded layout == natural layout on
    the prefix, exact zeros on the padding (the inertness the embedding
    relies on)."""
    from abip.cones import cone_barrier_prox

    rng = np.random.default_rng(5)
    spec = ConeSpec(soc=(6, 4), rsoc=(5,), free=2, nonneg=7)
    lay = ConeLayout(spec)
    pad = PaddedConeLayout.from_layout(lay, lay.n + 9, lay.num_blocks + 2)
    t = rng.standard_normal(lay.n + 9)
    lam = np.abs(rng.standard_normal(lay.n + 9)) + 0.1
    out_pad = np.asarray(cone_barrier_prox(jnp.asarray(t),
                                           jnp.asarray(lam), pad))
    out_nat = np.asarray(cone_barrier_prox(jnp.asarray(t[: lay.n]),
                                           jnp.asarray(lam[: lay.n]), lay))
    np.testing.assert_allclose(out_pad[: lay.n], out_nat, rtol=1e-13)
    assert (out_pad[lay.n:] == 0.0).all()


def test_padded_layout_interior_point_and_tie():
    spec = ConeSpec(soc=(4,), rsoc=(3,), nonneg=5)
    lay = ConeLayout(spec)
    pad = PaddedConeLayout.from_layout(lay, lay.n + 6, lay.num_blocks)
    ip = np.asarray(pad.interior_point(jnp.float64))
    assert (ip[lay.n:] == 0.0).all()
    np.testing.assert_array_equal(ip[: lay.n],
                                  np.asarray(lay.interior_point(jnp.float64)))
    e = np.abs(np.random.default_rng(3).standard_normal(pad.n)) + 0.5
    tied_pad = np.asarray(pad.segment_mean_tie(jnp.asarray(e)))
    tied_nat = np.asarray(lay.segment_mean_tie(jnp.asarray(e[: lay.n])))
    np.testing.assert_allclose(tied_pad[: lay.n], tied_nat, rtol=1e-13)
    # non-block (incl. padded) entries pass through untouched
    np.testing.assert_array_equal(tied_pad[lay.n:], e[lay.n:])


@pytest.mark.parametrize("normalize", [True, False])
def test_het_batch_matches_device_route(normalize):
    """Per-lane parity of the ONE-program mixed-cone batch vs the
    single-instance device solver at each lane's natural shape."""
    from abip.parallel.batched_qcp import solve_qcp_device

    probs = _mini_problems(6)   # 6 distinct cone structures / shapes
    res = solve_qcp_het_batch(probs, eps=1e-5, normalize=normalize,
                              cadence="chunk", inner_crit_period=16)
    st = np.asarray(res.status)
    assert (st == 1).all(), f"het lanes not all solved: {st}"
    for k, (A, b, c, _Q, spec) in enumerate(probs):
        ref = solve_qcp_device(
            jnp.asarray(A, jnp.float64), jnp.asarray(b, jnp.float64),
            jnp.asarray(c, jnp.float64), cones=spec, eps=1e-5,
            normalize=normalize, cadence="chunk", inner_crit_period=16)
        assert int(ref.status) == 1
        pobj = float(np.asarray(res.pobj)[k])
        assert abs(pobj - float(ref.pobj)) <= 1e-4 * (1 + abs(float(ref.pobj))), (
            k, pobj, float(ref.pobj))
        # padding must stay exactly inert
        n = A.shape[1]
        m = A.shape[0]
        assert np.abs(np.asarray(res.x)[k, n:]).max(initial=0.0) < 1e-12
        assert np.abs(np.asarray(res.y)[k, m:]).max(initial=0.0) < 1e-12


def test_het_batch_oracle_objectives():
    """Mixed-suite objectives against the committed conic-mini optima."""
    from benchmarks.conic_mini import instances

    probs, stars = [], []
    for (_n, A, b, c, spec, pobj_star) in instances():
        if pobj_star is None:
            continue
        probs.append((A, b, c, None, spec))
        stars.append(pobj_star)
    res = solve_qcp_het_batch(probs, eps=1e-6, inner_crit_period=16)
    st = np.asarray(res.status)
    assert (st == 1).all()
    for k, star in enumerate(stars):
        pobj = float(np.asarray(res.pobj)[k])
        assert abs(pobj - star) <= 1e-4 * (1 + abs(star)), (k, pobj, star)


def test_het_route_auto_and_forced_agree():
    """route='auto' (pool when padding waste > 2x) must return the same
    statuses/objectives as the forced lockstep batch -- the r04 hardware
    measurement made the padded batch a footgun on mixed suites
    (0.12x the per-instance rate), so 'auto' is the shipped default."""
    probs = _mini_problems(4)
    kw = dict(eps=1e-5, precision="f64", normalize=True)
    r_auto = solve_qcp_het_batch(probs, **kw)
    r_batch = solve_qcp_het_batch(probs, route="batch", **kw)
    assert (np.asarray(r_auto.status) == 1).all()
    np.testing.assert_array_equal(np.asarray(r_auto.status),
                                  np.asarray(r_batch.status))
    np.testing.assert_allclose(np.asarray(r_auto.pobj),
                               np.asarray(r_batch.pobj),
                               rtol=1e-4, atol=1e-6)
