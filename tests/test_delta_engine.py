"""Anchored-delta endgame engine (`ops/admm_delta.py`).

The delta engine must reproduce the f64 steps-engine trajectory at
chunk granularity (same iteration counts, same solutions) while doing
all per-iteration work in f32.  Reference hot loop:
`src/abip-lp/src/abip.c:2131-2215`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from abip import hsd
from abip.ops.admm_delta import run_delta_chunk
from abip.parallel.batched import device_solve_lp, solve_lp_batch

f64 = jnp.float64


def _smoke_lp(m=40, n=300, seed=0):
    rng = np.random.default_rng(seed)
    Ar = rng.standard_normal((m, n - m))
    A = np.concatenate([Ar, np.eye(m)], axis=1)
    x0 = rng.random(n) + 0.5
    y0 = rng.standard_normal(m)
    s0 = rng.random(n) + 0.5
    return A, A @ x0, A.T @ y0 + s0


def _setup(A, b, c, rho_y=1e-3):
    A = jnp.asarray(A, f64)
    b = jnp.asarray(b, f64)
    c = jnp.asarray(c, f64)
    m, n = A.shape
    N64 = rho_y * jnp.eye(m, dtype=f64) + A @ A.T
    chol = jax.lax.linalg.cholesky(N64)
    solve64 = lambda r: jax.scipy.linalg.cho_solve((chol, True), r)  # noqa: E731
    h = jnp.concatenate([-b, c])
    g_y = solve64(h[:m] + A @ h[m:])
    g_x = A.T @ g_y - h[m:]
    g = jnp.concatenate([g_y, -g_x])
    return A, b, c, solve64, h, g, jnp.dot(h, g), rho_y


def _absolute_step(A, solve64, h, g, g_th, rho_y, u, v, mu, alpha=1.8):
    m, n = A.shape
    l = m + n + 1
    r = u + v
    q = jnp.concatenate([rho_y * r[:m], r[m:m + n]])
    q = q - r[l - 1] * h
    q = q - (jnp.dot(q, g) / (g_th + 1.0)) * h
    wx = -q[m:]
    z_y = solve64(q[:m] + A @ wx)
    z_x = A.T @ z_y - wx
    tau_t = r[l - 1] + jnp.dot(z_y, h[:m]) + jnp.dot(z_x, h[m:])
    u_t = jnp.concatenate([z_y, z_x, tau_t[None]])
    return hsd.admm_update(u, v, u, u_t, mu, alpha, m)


def test_delta_chunk_matches_f64_trajectory():
    """T f32 delta iterations track T absolute f64 iterations to a
    small fraction of the iterate movement, and the stage-average
    accumulators agree."""
    A, b, c = _smoke_lp(seed=1)
    A, b, c, solve64, h, g, g_th, rho_y = _setup(A, b, c)
    m, n = A.shape
    l = m + n + 1
    u = jnp.concatenate([jnp.zeros((m,), f64), jnp.ones((l - m,), f64)])
    v = u
    for mu in (1.0, 1e-2, 1e-4):
        for _ in range(400):
            u, v = _absolute_step(A, solve64, h, g, g_th, rho_y, u, v, mu)
    mu, T = 1e-5, 192
    ua, va = u, v
    usum = jnp.zeros((l,), f64)
    vsum = jnp.zeros((l,), f64)
    for _ in range(T):
        ua, va = _absolute_step(A, solve64, h, g, g_th, rho_y, ua, va, mu)
        usum = usum + ua
        vsum = vsum + va
    res = run_delta_chunk(A, solve64, h, g, g_th, rho_y, mu, 1.8, 0.0,
                          u, v, jnp.zeros((l,), f64), jnp.zeros((l,), f64),
                          jnp.zeros((), jnp.int32), jnp.inf,
                          T=T, probe=8)
    assert int(res.t_done) == T
    movement = float(jnp.linalg.norm(ua - u)) + 1e-12
    err = float(jnp.abs(res.u - ua).max())
    assert err < 1e-4 * max(movement, 1.0), (err, movement)
    assert float(jnp.abs(res.v - va).max()) < 1e-4 * max(movement, 1.0)
    # accumulators track the running sums (straggler-fix invariant)
    rel = float(jnp.abs(res.u_sum - usum).max()) / (
        float(jnp.abs(usum).max()) + 1e-12)
    assert rel < 1e-6, rel


def test_delta_chunk_converged_lane_runs_zero_trips():
    """A lane whose entry qres already beats the threshold must not
    iterate (the vmapped endgame relies on this for lane idling)."""
    A, b, c = _smoke_lp(seed=2)
    A, b, c, solve64, h, g, g_th, rho_y = _setup(A, b, c)
    m, n = A.shape
    l = m + n + 1
    u = jnp.concatenate([jnp.zeros((m,), f64), jnp.ones((l - m,), f64)])
    v = u
    res = run_delta_chunk(A, solve64, h, g, g_th, rho_y, 1e-5, 1.8, 1e3,
                          u, v, jnp.zeros((l,), f64), jnp.zeros((l,), f64),
                          jnp.zeros((), jnp.int32), 1e-9,
                          T=256, probe=8)
    assert int(res.t_done) == 0
    np.testing.assert_array_equal(np.asarray(res.u), np.asarray(u))


@pytest.mark.parametrize("eps", [1e-6, 1e-8])
def test_delta_engine_full_solve_matches_steps(eps):
    """Full driver with engine='delta': same status and near-identical
    ADMM counts as the f64-authority steps engine, solution matches."""
    from bench import reference_smoke_lp

    A, b, c = reference_smoke_lp(m=30, n_rand=400, seed=11)
    kw = dict(eps=eps, max_ipm=200, max_admm=400_000, solver="inverse",
              qres_period=768, avg_period=20, precision="mixed",
              cadence="chunk")
    rs = device_solve_lp(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c),
                         engine="steps", **kw)
    rd = device_solve_lp(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c),
                         engine="delta", **kw)
    assert int(rs.status) == 1 and int(rd.status) == 1
    # trajectory parity: counts within 5% (chunk-granular check points)
    ks, kd = int(rs.admm_iters), int(rd.admm_iters)
    assert abs(ks - kd) <= max(0.05 * ks, 2 * 768), (ks, kd)
    assert float(rd.rel_gap) < 1.05 * eps
    assert abs(float(rs.pobj) - float(rd.pobj)) < 1e-4 * (
        1 + abs(float(rs.pobj)))


def test_sprint2_delta_endgame_batched():
    """sprint2 with endgame='delta' solves the batch to the same counts
    as endgame='steps' and matches the scipy oracle."""
    from scipy.optimize import linprog

    from bench import reference_smoke_lp

    data = [reference_smoke_lp(m=25, n_rand=300, seed=50 + i)
            for i in range(3)]
    batch = tuple(map(np.stack, zip(*data)))
    kw = dict(eps=1e-6, max_ipm=200, max_admm=200_000, solver="inverse",
              qres_period=768, avg_period=20, precision="mixed",
              engine="sprint2", sprint_T=32, sprint_mu_switch=1e-4)
    r_s = solve_lp_batch(*batch, endgame="steps", **kw)
    r_d = solve_lp_batch(*batch, endgame="delta", **kw)
    assert (np.asarray(r_d.status) == 1).all()
    np.testing.assert_allclose(np.asarray(r_d.admm_iters),
                               np.asarray(r_s.admm_iters), rtol=0.05)
    for i, (A, b, c) in enumerate(data):
        ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, None),
                      method="highs")
        assert ref.status == 0
        assert abs(float(r_d.pobj[i]) - ref.fun) < 1e-5 * (1 + abs(ref.fun))


def _kernel_anchors(m, n, seed, lanes):
    """Mid-solve anchors of `len(lanes)` LPs; lanes[i] = (thresh, qres)
    sets lane i's stop threshold and entry criterion value."""
    from abip.ops.admm_delta import delta_anchor

    out = []
    for i, (thresh, qres) in enumerate(lanes):
        A, b, c = _smoke_lp(m=m, n=n, seed=seed + i)
        A, b, c, solve64, h, g, g_th, rho_y = _setup(A, b, c)
        l = m + n + 1
        u = jnp.concatenate([jnp.zeros((m,), f64), jnp.ones((l - m,), f64)])
        v = u
        for mu in (1.0, 1e-2, 1e-4):
            for _ in range(100):
                u, v = _absolute_step(A, solve64, h, g, g_th, rho_y, u, v,
                                      mu)
        z = jnp.zeros((l,), f64)
        out.append(delta_anchor(A, solve64, h, g, g_th, rho_y, 1e-5, 1.8,
                                thresh, u, v, z, z,
                                jnp.zeros((), jnp.int32), qres))
    return jax.tree.map(lambda *x: jnp.stack(x), *out)


def _run_chunks(anc, T, probe, interpret):
    """(kernel, plain f32, plain f64) outputs of one vmapped chunk."""
    from abip.ops.admm_delta import _delta_kernel_call, _delta_ref

    def ref64(a):
        return _delta_ref(jax.tree.map(lambda x: x.astype(f64), a), T, probe)

    ker = jax.vmap(lambda a: _delta_kernel_call(a, T, probe,
                                                interpret=interpret))(anc)
    r32 = jax.vmap(lambda a: _delta_ref(a, T, probe))(anc)
    return ker, r32, jax.vmap(ref64)(anc)


def _max_rel_err(outs, ref):
    return max(float(np.abs(np.asarray(o, np.float64) - np.asarray(r)).max()
                     / (1.0 + np.abs(np.asarray(r)).max()))
               for o, r in zip(outs, ref))


def _check_kernel(ker, r32, r64, want_t):
    """The kernel stops where the f64 evaluation of the same math stops,
    and is as accurate as plain f32 XLA: the two f32 evaluations sum in
    different orders, so each is held to the f64 result, the kernel
    within 4x the plain f32 error (floor 1e-5 relative)."""
    t_ker = np.asarray(ker[6])[:, 5].astype(int)
    np.testing.assert_array_equal(t_ker, np.asarray(r64[6])[:, 5])
    np.testing.assert_array_equal(t_ker, want_t)
    e_ker, e_32 = _max_rel_err(ker, r64), _max_rel_err(r32, r64)
    assert e_ker <= max(4.0 * e_32, 1e-5), (e_ker, e_32)


def _middle_threshold(m, n, seed, probe):
    """A threshold between the f64 criterion values after one and after
    two probes, so the lane stops after exactly two probes."""
    from abip.ops.admm_delta import _delta_ref

    anc = _kernel_anchors(m, n, seed, [(0.0, jnp.inf)])
    q = [float(jax.vmap(lambda a: _delta_ref(
        jax.tree.map(lambda x: x.astype(f64), a), T, probe))(anc)[6][0, 4])
        for T in (probe, 2 * probe)]
    assert q[0] > 1.01 * q[1], q
    return float(np.sqrt(q[0] * q[1]))


@pytest.mark.parametrize("case", ["one_lane", "per_lane_stops",
                                  "converged_lane", "ragged_block"])
def test_delta_kernel_interpret_matches_ref(case):
    """The Triton delta kernel (interpret mode) against `_delta_ref`:
    one lane; three lanes stopping at T, after two probes and after one
    probe; a lane whose entry criterion is already met (zero trips); and
    an (m, n) that fills neither its row tiles nor its power-of-two
    column block."""
    T, probe = 32, 8
    m, n, seed = 16, 140, 5
    if case == "one_lane":
        lanes, want = [(0.0, jnp.inf)], [T]
    elif case == "per_lane_stops":
        mid = _middle_threshold(m, n, seed + 1, probe)
        lanes = [(0.0, jnp.inf), (mid, jnp.inf), (1e30, jnp.inf)]
        want = [T, 2 * probe, probe]
    elif case == "converged_lane":
        lanes, want = [(0.0, jnp.inf), (1.0, 0.0)], [T, 0]
    else:
        m, n = 21, 130
        lanes, want = [(0.0, jnp.inf)], [T]
    anc = _kernel_anchors(m, n, seed, lanes)
    _check_kernel(*_run_chunks(anc, T, probe, interpret=True), want)


def test_delta_kernel_config_blocks():
    """Register blocks are the next powers of two; row tiles hold ~64 f32
    registers a thread and never exceed the y block."""
    from abip.ops.admm_delta import kernel_config

    assert kernel_config(50, 2000) == (64, 2048, 8, 8)
    assert kernel_config(500, 5000) == (512, 8192, 4, 16)
    assert kernel_config(3, 40) == (4, 64, 4, 4)
    for m, n in ((1, 1), (17, 999), (1000, 10000)):
        MP, NP, bm, nw = kernel_config(m, n)
        assert MP >= m > MP // 2 or MP == m == 1
        assert NP >= n > NP // 2 or NP == n == 1
        assert 1 <= bm <= MP and bm & (bm - 1) == 0
        assert bm * NP <= 64 * 32 * nw or bm == 1


def test_delta_kernel_choice(monkeypatch):
    """The kernel runs only on the GPU, and only for lanes one program
    covers in at most `KERNEL_MAX_TRIPS` row-tile trips with blocks no
    wider than measured; the CPU always takes the plain XLA chunk.  The
    shapes are those of the H100 sweep (`tools/delta_sweep.py`)."""
    from abip.ops import admm_delta

    assert not admm_delta.use_kernel(50, 2000)
    monkeypatch.setattr(admm_delta.jax, "default_backend", lambda: "gpu")
    for m, n in ((50, 2000), (80, 2000), (120, 500), (30, 4000),
                 (16, 8000)):                       # measured wins
        assert admm_delta.use_kernel(m, n), (m, n)
    for m, n in ((100, 2000), (150, 1000), (250, 500),
                 (500, 5000)):                      # measured losses
        assert not admm_delta.use_kernel(m, n), (m, n)
    assert not admm_delta.use_kernel(4, 20000)      # block wider than 8192
    assert not admm_delta.use_kernel(40, 30)        # m > n


def test_delta_kernel_lowers_for_cuda():
    """The batched kernel lowers to a Triton call for the GPU (catches an
    unsupported primitive or a non-power-of-two block without a card)."""
    from abip.ops.admm_delta import _delta_kernel_call

    anc = _kernel_anchors(12, 100, 0, [(0.0, jnp.inf)] * 2)
    fn = jax.jit(jax.vmap(lambda a: _delta_kernel_call(a, 64, 8)))
    text = fn.trace(anc).lower(lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text


@pytest.mark.gpu
def test_delta_kernel_compiled_matches_ref():
    """The compiled Triton kernel on the card against `_delta_ref`, with
    per-lane stops (full chunk, first probe, zero trips)."""
    T, probe = 256, 8
    anc = _kernel_anchors(40, 300, 3, [(0.0, jnp.inf), (1e30, jnp.inf),
                                       (1.0, 0.0)])
    _check_kernel(*_run_chunks(anc, T, probe, interpret=False),
                  [T, probe, 0])


@pytest.mark.gpu
def test_delta_engine_gpu_solve_matches_steps():
    """On the card the delta engine (kernel) solves a small batch to the
    f64 steps engine's optima."""
    from bench import reference_smoke_lp

    data = [reference_smoke_lp(m=30, n_rand=400, seed=70 + i)
            for i in range(4)]
    batch = tuple(map(np.stack, zip(*data)))
    kw = dict(eps=1e-6, max_ipm=200, max_admm=200_000, solver="inverse",
              qres_period=768, avg_period=20)
    rd = solve_lp_batch(*batch, engine="delta", precision="mixed", **kw)
    rs = solve_lp_batch(*batch, engine="steps", precision="f64", **kw)
    assert (np.asarray(rd.status) == 1).all()
    np.testing.assert_allclose(np.asarray(rd.pobj), np.asarray(rs.pobj),
                               rtol=1e-5)


@pytest.mark.parametrize("engine", ["steps", "delta"])
def test_delta_engine_certificates(engine):
    """Infeasible/unbounded detection must survive the engine swap
    (`abip.c:1565-1576` certificate classification)."""
    kw = dict(eps=1e-6, max_ipm=200, max_admm=200_000, solver="inverse",
              qres_period=768, avg_period=20, precision="mixed",
              cadence="chunk", engine=engine)
    A = jnp.asarray([[1.0, 1.0], [1.0, 1.0]])
    r = device_solve_lp(A, jnp.asarray([1.0, 3.0]),
                        jnp.asarray([1.0, 1.0]), **kw)
    assert int(r.status) == -2          # infeasible
    A2 = jnp.asarray([[1.0, -1.0]])
    r2 = device_solve_lp(A2, jnp.asarray([0.0]),
                         jnp.asarray([-1.0, 0.0]), **kw)
    assert int(r2.status) == -1         # unbounded
