"""Cone specifications and vectorized barrier-proximal kernels.

JAX re-derivation of the reference cone layer
(`/root/reference/src/abip-qcp/source/cones.c`).  The reference loops over
cone blocks in C and allocates scratch per block; here the entire cone tail
is processed in one shot:

  * scalar cones (zero / free / nonneg) are elementwise `jnp.where` masks,
  * SOC / RSOC blocks of arbitrary sizes are handled with SEGMENT
    reductions (`jax.ops.segment_sum` over a static element->block map),
    so a thousand mixed-size cones cost two segment-sums and a gather --
    no Python loop, no padding, fully fused by XLA.

Block ordering convention matches the reference dispatch
(`source/abip.c:358-409`): [soc blocks..., rsoc blocks..., free, zero,
nonneg].

The deep scalar branching of the C prox (`cones.c:130-248`) is re-derived
as domain-safe `jnp.where` chains: every untaken branch still evaluates, so
all denominators/sqrt arguments are guarded (SURVEY.md section 7 "hard
parts").
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

_TINY = 1e-300  # guard for divisions in untaken branches
_SOC_TOL = 1e-9  # |a| threshold (`cones.c:133,137`)


@dataclasses.dataclass(frozen=True)
class ConeSpec:
    """Cone structure K = soc x rsoc x free x zero x nonneg.

    Mirrors the reference `ABIPCone {f,z,l,q,rq}`
    (`src/abip-qcp/include/abip.h:67-76`) with the dims validation of
    `cones.c:37-82`.
    """

    soc: Tuple[int, ...] = ()
    rsoc: Tuple[int, ...] = ()
    free: int = 0
    zero: int = 0
    nonneg: int = 0

    def __post_init__(self):
        for q in self.soc:
            if q < 1:
                raise ValueError(f"soc cone dims must be >= 1; got {q}")
        for q in self.rsoc:
            if q < 3:
                raise ValueError(f"rsoc cone dims must be >= 3; got {q}")
        if self.free < 0 or self.zero < 0 or self.nonneg < 0:
            raise ValueError("cone dims must be nonnegative")

    @property
    def dim(self) -> int:
        return sum(self.soc) + sum(self.rsoc) + self.free + self.zero + self.nonneg

    @classmethod
    def lp(cls, n: int) -> "ConeSpec":
        return cls(nonneg=n)

    def validate_dim(self, n: int):
        if self.dim != n:
            raise ValueError(
                f"cone dimensions {self.dim} do not match problem dim n = {n}"
            )


# element-class codes used in the layout arrays
_NONNEG, _FREE, _ZERO, _SOC, _RSOC = 0, 1, 2, 3, 4


class ConeLayout:
    """Static (numpy) index structure compiled from a ConeSpec.

    Precomputed once at setup; everything here is jit-constant.
    """

    def __init__(self, spec: ConeSpec):
        self.spec = spec
        n = spec.dim
        kind = np.zeros(n, np.int32)
        seg = np.zeros(n, np.int64)      # element -> block id (soc/rsoc only)
        head = np.zeros(n, np.int32)     # 1 for block head, 2 for rsoc 2nd head
        block_start = []                 # head element index per block

        pos = 0
        blk = 0
        for q in spec.soc:
            if q == 1:
                # 1-d SOC is the nonneg ray (`source/abip.c:364-367`)
                kind[pos] = _NONNEG
                seg[pos] = blk
            else:
                kind[pos : pos + q] = _SOC
                seg[pos : pos + q] = blk
                head[pos] = 1
            block_start.append(pos)
            pos += q
            blk += 1
        for q in spec.rsoc:
            kind[pos : pos + q] = _RSOC
            seg[pos : pos + q] = blk
            head[pos] = 1
            head[pos + 1] = 2
            block_start.append(pos)
            pos += q
            blk += 1
        kind[pos : pos + spec.free] = _FREE
        pos += spec.free
        kind[pos : pos + spec.zero] = _ZERO
        pos += spec.zero
        kind[pos : pos + spec.nonneg] = _NONNEG
        pos += spec.nonneg
        assert pos == n

        self.n = n
        self.num_blocks = max(blk, 1)
        self.kind = kind
        self.seg = seg
        self.head = head
        self.block_start = np.asarray(block_start, np.int64) if block_start else np.zeros(1, np.int64)
        self.has_blocks = blk > 0
        self.has_soc = bool((kind == _SOC).any())
        self.has_rsoc = bool((kind == _RSOC).any())

    # ---------------------------------------------------------------- #
    def interior_point(self, dtype) -> jnp.ndarray:
        """Cone-aware cold start (`source/abip.c:925-976`): SOC head = 1,
        RSOC heads = (1,1), nonneg = 1, free/zero = 0."""
        x = np.zeros(self.n, dtype=np.float64)
        x[self.kind == _NONNEG] = 1.0
        x[self.head > 0] = 1.0
        x[(self.kind == _FREE) | (self.kind == _ZERO)] = 0.0
        return jnp.asarray(x, dtype)

    def interiorize(self, x: np.ndarray, floor: float,
                    dual: bool = False) -> np.ndarray:
        """Project a caller-provided point safely into the cone interior
        (host-side, warm-start path).

        The reference has no conic warm start (its `ABIP(init)`/`ABIP(solve)`
        split, `source/abip.c:1271-1311`, reuses the factorization but
        always cold-starts); this is the conic analogue of the LP driver's
        floored warm start.  `dual=True` maps through K*: the dual of the
        free cone is {0} and of the zero cone is free (self-dual otherwise).
        """
        x = np.array(x, dtype=np.float64, copy=True)
        kind = self.kind
        nn = kind == _NONNEG
        x[nn] = np.maximum(x[nn], floor)
        if dual:
            x[kind == _FREE] = 0.0
        else:
            x[kind == _ZERO] = 0.0
        if self.has_blocks:
            seg = self.seg
            h1 = (self.head == 1)
            h2 = (self.head == 2)
            body = ((kind == _SOC) | (kind == _RSOC)) & ~h1 & ~h2
            nb = self.num_blocks
            bsq = np.zeros(nb)
            np.add.at(bsq, seg[body], x[body] ** 2)
            # SOC: head >= ||body|| + floor
            soc_h = h1 & (kind == _SOC)
            x[soc_h] = np.maximum(x[soc_h],
                                  np.sqrt(bsq[seg[soc_h]]) + floor)
            # RSOC: t1 >= floor, then t2 >= ||body||^2/(2 t1) + floor
            r1 = h1 & (kind == _RSOC)
            r2 = h2 & (kind == _RSOC)
            x[r1] = np.maximum(x[r1], floor)
            t1 = np.zeros(nb)
            t1[seg[r1]] = x[r1]
            need = bsq[seg[r2]] / np.maximum(2.0 * t1[seg[r2]], _TINY) + floor
            x[r2] = np.maximum(x[r2], need)
        return x

    def segment_mean_tie(self, e: jnp.ndarray) -> jnp.ndarray:
        """Replace entries within each soc/rsoc block by the block mean --
        the cone-block tying of the QCP equilibration
        (`source/qcp_config.c:194-212`)."""
        if not self.has_blocks:
            return e
        seg = jnp.asarray(self.seg)
        in_blk = jnp.asarray((self.kind == _SOC) | (self.kind == _RSOC))
        sums = jax.ops.segment_sum(jnp.where(in_blk, e, 0.0), seg, self.num_blocks)
        cnts = jax.ops.segment_sum(in_blk.astype(e.dtype), seg, self.num_blocks)
        means = sums / jnp.maximum(cnts, 1.0)
        return jnp.where(in_blk, means[seg], e)


@dataclasses.dataclass(frozen=True)
class PaddedConeLayout:
    """Vmappable cone layout: the element-class arrays are DATA, not
    jit constants, so one compiled program can solve a batch of
    instances with DIFFERENT cone structures (the heterogeneous-suite
    gap the per-`ConeSpec` `solve_qcp_batch` cannot cover).

    Built by `PaddedConeLayout.stack`: each lane's `ConeLayout` arrays
    are padded to a common element count with ZERO-cone elements (prox
    forces the padded primal entries to 0; with zero-padded A columns
    and c entries they are inert -- the standard embedding) and share a
    common static block count `num_blocks` (unused block slots receive
    no elements, so their segment-sum values are never scattered back).

    Registered as a pytree with (kind, seg, head) as leaves and the
    shape/class flags as static metadata: `jax.vmap` maps the per-lane
    arrays while every lane shares one compiled prox.  `has_soc` /
    `has_rsoc` are suite-wide ORs -- a lane without SOC blocks simply
    masks the (cheap, segment-level) SOC math out elementwise.

    Duck-types the `ConeLayout` surface the traced path uses:
    `kind/seg/head/num_blocks/has_blocks/has_soc/has_rsoc/n`,
    `interior_point`, `segment_mean_tie`.
    """

    kind: jnp.ndarray   # (n,) int32 element-class codes
    seg: jnp.ndarray    # (n,) int32 element -> block id
    head: jnp.ndarray   # (n,) int32: 1 = block head, 2 = rsoc 2nd head
    n: int = dataclasses.field(metadata=dict(static=True))
    num_blocks: int = dataclasses.field(metadata=dict(static=True))
    has_blocks: bool = dataclasses.field(metadata=dict(static=True))
    has_soc: bool = dataclasses.field(metadata=dict(static=True))
    has_rsoc: bool = dataclasses.field(metadata=dict(static=True))

    @classmethod
    def from_layout(cls, lay: ConeLayout, n_pad: int,
                    nb_pad: int) -> "PaddedConeLayout":
        if n_pad < lay.n:
            raise ValueError(f"n_pad {n_pad} < layout dim {lay.n}")
        if nb_pad < lay.num_blocks:
            raise ValueError(
                f"nb_pad {nb_pad} < layout blocks {lay.num_blocks}")
        kind = np.full(n_pad, _ZERO, np.int32)
        seg = np.zeros(n_pad, np.int32)
        head = np.zeros(n_pad, np.int32)
        kind[: lay.n] = lay.kind
        seg[: lay.n] = lay.seg.astype(np.int32)
        head[: lay.n] = lay.head
        return cls(kind=jnp.asarray(kind), seg=jnp.asarray(seg),
                   head=jnp.asarray(head), n=n_pad, num_blocks=nb_pad,
                   has_blocks=lay.has_blocks, has_soc=lay.has_soc,
                   has_rsoc=lay.has_rsoc)

    @classmethod
    def stack(cls, specs, n_pad: int | None = None) -> "PaddedConeLayout":
        """Stack per-lane ConeSpecs into one batched layout of shape
        (B, n_pad) with suite-wide static flags."""
        lays = [ConeLayout(s) for s in specs]
        n_pad = max(l.n for l in lays) if n_pad is None else n_pad
        nb_pad = max(l.num_blocks for l in lays)
        padded = [cls.from_layout(l, n_pad, nb_pad) for l in lays]
        return cls(
            kind=jnp.stack([p.kind for p in padded]),
            seg=jnp.stack([p.seg for p in padded]),
            head=jnp.stack([p.head for p in padded]),
            n=n_pad, num_blocks=nb_pad,
            has_blocks=any(l.has_blocks for l in lays),
            has_soc=any(l.has_soc for l in lays),
            has_rsoc=any(l.has_rsoc for l in lays),
        )

    def interior_point(self, dtype) -> jnp.ndarray:
        """Traced cone-aware cold start (`source/abip.c:925-976`):
        SOC/RSOC heads and nonneg elements start at 1, the rest at 0."""
        one = (self.kind == _NONNEG) | (self.head > 0)
        return jnp.where(one, 1.0, 0.0).astype(dtype)

    def segment_mean_tie(self, e: jnp.ndarray) -> jnp.ndarray:
        """See `ConeLayout.segment_mean_tie` (`qcp_config.c:194-212`)."""
        if not self.has_blocks:
            return e
        in_blk = (self.kind == _SOC) | (self.kind == _RSOC)
        sums = jax.ops.segment_sum(jnp.where(in_blk, e, 0.0), self.seg,
                                   self.num_blocks)
        cnts = jax.ops.segment_sum(in_blk.astype(e.dtype), self.seg,
                                   self.num_blocks)
        means = sums / jnp.maximum(cnts, 1.0)
        return jnp.where(in_blk, means[self.seg], e)


jax.tree_util.register_dataclass(
    PaddedConeLayout,
    data_fields=("kind", "seg", "head"),
    meta_fields=("n", "num_blocks", "has_blocks", "has_soc", "has_rsoc"),
)


# -------------------------------------------------------------------- #
# prox kernels                                                         #
# -------------------------------------------------------------------- #
def _nonneg_prox(t, lam):
    """Positive-orthant barrier prox (`cones.c:279-289`):
    the positive root of u^2 - t*u - lam = 0, branch-free and stable."""
    pos = 0.5 * (t + jnp.sqrt(t * t + 4.0 * lam))
    neg = 2.0 * lam / (-t * (1.0 + jnp.sqrt(1.0 + 4.0 * lam / (t * t + _TINY))) + _TINY)
    return jnp.where(t >= 0, pos, neg)


def _soc_blocks(t, lam_e, layout: ConeLayout):
    """SOC barrier prox on all SOC blocks at once (`cones.c:130-161`).

    t: full cone tail (n,);  lam_e: per-element lambda (n,).
    Returns the prox value for elements in SOC blocks (garbage elsewhere).
    """
    seg = jnp.asarray(layout.seg)
    is_soc = jnp.asarray(layout.kind == _SOC)
    is_head = jnp.asarray(layout.head == 1) & is_soc
    nb = layout.num_blocks

    # per-block reductions
    body = is_soc & ~is_head
    bsq = jax.ops.segment_sum(jnp.where(body, t * t, 0.0), seg, nb)  # ||b||^2
    a = jax.ops.segment_sum(jnp.where(is_head, t, 0.0), seg, nb)     # t[0]
    lam = jax.ops.segment_sum(jnp.where(is_head, lam_e, 0.0), seg, nb)
    lam = jnp.maximum(lam, _TINY)

    # branch |a| <= tol  (`cones.c:137-140`)
    x0_zero = jnp.sqrt(2.0 * lam + bsq / 4.0)
    scale_zero = 0.5

    # branch |a| > tol  (`cones.c:141-159`)
    denom_r = 8.0 * lam - a * a + bsq
    r = 16.0 * a * a / (
        denom_r + jnp.sqrt(denom_r * denom_r + 32.0 * a * a * lam) + _TINY
    )
    disc = jnp.sqrt(jnp.maximum(r * (r + 8.0), 0.0))
    s1 = (r - disc) / 2.0
    s2 = (r + disc) / 2.0
    s = jnp.where(a > 0, s2, s1)
    s_safe = jnp.where(jnp.abs(s) < _TINY, _TINY, s)
    eta = (s + 2.0) * a / s_safe
    scale_pos = (s + 2.0) / (s + 4.0)

    small_a = jnp.abs(a) <= _SOC_TOL
    x0 = jnp.where(small_a, x0_zero, eta)
    scale = jnp.where(small_a, scale_zero, scale_pos)

    # scatter back
    x = jnp.where(is_head, x0[seg], t * scale[seg])
    return x


def _rsoc_blocks(t, lam_e, layout: ConeLayout):
    """RSOC barrier prox on all RSOC blocks at once (`cones.c:169-248`).

    K = {(t1,t2,x) : 2 t1 t2 >= ||x||^2, t1,t2 >= 0}.
    """
    seg = jnp.asarray(layout.seg)
    is_rsoc = jnp.asarray(layout.kind == _RSOC)
    h1 = jnp.asarray(layout.head == 1) & is_rsoc
    h2 = jnp.asarray(layout.head == 2) & is_rsoc
    body = is_rsoc & ~h1 & ~h2
    nb = layout.num_blocks

    ze = jax.ops.segment_sum(jnp.where(h1, t, 0.0), seg, nb)  # zeta_eta
    zn = jax.ops.segment_sum(jnp.where(h2, t, 0.0), seg, nb)  # zeta_nu
    zxsq = jax.ops.segment_sum(jnp.where(body, t * t, 0.0), seg, nb)
    lam = jax.ops.segment_sum(jnp.where(h1, lam_e, 0.0), seg, nb)
    lam = jnp.maximum(lam, _TINY)

    sum_zz = ze + zn
    d = 2.0 * ze * zn - zxsq          # the discriminating quantity
    g = d / (2.0 * lam)               # appears throughout `cones.c:191-215`
    g_neg = jnp.where(g < 0, -g, 1.0)  # guard: used only when d < 0
    g_pos = jnp.where(g > 0, g, 1.0)   # guard: used only when d > 0
    q = 4.0 * (ze * ze + zn * zn + zxsq) / lam + 16.0

    # w for d < 0 (`cones.c:192-202`)
    w_neg = (2.0 * sum_zz * sum_zz / lam) / g_neg / (
        1.0 + 4.0 / g_neg + jnp.sqrt(1.0 + q / (g_neg * g_neg))
    )
    # w for d >= 0 (`cones.c:204-214`)
    w_pos = g_pos * (1.0 - 4.0 / g_pos + jnp.sqrt(1.0 + q / (g_pos * g_pos))) / 2.0
    w = jnp.where(d < 0, w_neg, w_pos)

    # sum_zz > 0 branch (`cones.c:216-221`)
    s_a = (w + jnp.sqrt(jnp.maximum(w * (w + 4.0), 0.0))) / 2.0
    # sum_zz <= 0, w > 10 (`cones.c:223-228`): s near 0 via conjugate form
    s_b = 2.0 / (w + 2.0 + jnp.sqrt(jnp.maximum(w * (w + 4.0), 0.0)) + _TINY)
    # sum_zz <= 0, w <= 10 (`cones.c:229-235`)
    s_c = (w - jnp.sqrt(jnp.maximum(w * (w + 4.0), 0.0))) / 2.0

    def heads_std(s):
        den = s * (s + 2.0)
        den = jnp.where(jnp.abs(den) < _TINY, _TINY, den)
        x1 = (ze * (s + 1.0) ** 2 + zn * (s + 1.0)) / den
        x2 = (zn * (s + 1.0) ** 2 + ze * (s + 1.0)) / den
        return x1, x2, (s + 1.0) / (s + 2.0)

    def heads_b(s):
        den = (s - 1.0) * (s + 1.0)
        den = jnp.where(jnp.abs(den) < _TINY, _TINY, den)
        x1 = (ze * s * s + zn * s) / den
        x2 = (zn * s * s + ze * s) / den
        return x1, x2, s / (s + 1.0)

    xa1, xa2, sca = heads_std(s_a)
    xb1, xb2, scb = heads_b(s_b)
    xc1, xc2, scc = heads_std(s_c)

    pos_branch = sum_zz > 0
    b_branch = (~pos_branch) & (w > 10.0)
    x1 = jnp.where(pos_branch, xa1, jnp.where(b_branch, xb1, xc1))
    x2 = jnp.where(pos_branch, xa2, jnp.where(b_branch, xb2, xc2))
    sc = jnp.where(pos_branch, sca, jnp.where(b_branch, scb, scc))

    # degenerate sum_zz == 0 branch (`cones.c:181-188`)
    x2_deg = (-ze + jnp.sqrt(ze * ze + 4.0 * lam + zxsq)) / 2.0
    x1_deg = x2_deg + ze      # so that x1 - x2 = zeta_eta - (-zeta_eta)/... see note
    # NOTE: the reference writes x[0] = x[0] + zeta_eta with x[0] stale;
    # the well-defined completion is x1*x2 consistent: x1 = x2 + ze.
    deg = sum_zz == 0
    x1 = jnp.where(deg, x1_deg, x1)
    x2 = jnp.where(deg, x2_deg, x2)
    sc = jnp.where(deg, 0.5, sc)

    x = jnp.where(h1, x1[seg], jnp.where(h2, x2[seg], t * sc[seg]))
    return x


def cone_barrier_prox(t: jnp.ndarray, lam_e: jnp.ndarray, layout: ConeLayout) -> jnp.ndarray:
    """Full cone-tail barrier prox (`solve_barrier_subproblem`,
    `source/abip.c:326-413`) for all cone classes at once.

    t: (n,) input vector; lam_e: (n,) per-element lambda = mu/(beta*rho_i).
    """
    kind = jnp.asarray(layout.kind)
    out = jnp.where(kind == _NONNEG, _nonneg_prox(t, lam_e), t)  # free: identity
    out = jnp.where(kind == _ZERO, 0.0, out)
    if layout.has_blocks:
        # static per-suite flags (suite-wide ORs on a PaddedConeLayout):
        # lanes without a class mask its segment math out elementwise
        if layout.has_soc:
            out = jnp.where(kind == _SOC, _soc_blocks(t, lam_e, layout), out)
        if layout.has_rsoc:
            out = jnp.where(kind == _RSOC, _rsoc_blocks(t, lam_e, layout), out)
    return out


def cone_membership_violation(x: jnp.ndarray, layout: ConeLayout) -> jnp.ndarray:
    """Max violation of K-membership; used by tests.

    zero: |x|; nonneg: max(-x, 0); soc: ||b|| - t; rsoc: ||b||^2 - 2 t1 t2.
    """
    kind = jnp.asarray(layout.kind)
    viol = jnp.max(jnp.where(kind == _NONNEG, jnp.maximum(-x, 0.0), 0.0))
    viol = jnp.maximum(viol, jnp.max(jnp.where(kind == _ZERO, jnp.abs(x), 0.0)))
    if layout.has_blocks:
        seg = jnp.asarray(layout.seg)
        nb = layout.num_blocks
        is_soc = jnp.asarray(layout.kind == _SOC)
        is_rsoc = jnp.asarray(layout.kind == _RSOC)
        h1 = jnp.asarray(layout.head == 1)
        h2 = jnp.asarray(layout.head == 2)
        body = (is_soc | is_rsoc) & ~h1 & ~h2
        bsq = jax.ops.segment_sum(jnp.where(body, x * x, 0.0), seg, nb)
        t0 = jax.ops.segment_sum(jnp.where(h1, x, 0.0), seg, nb)
        t1 = jax.ops.segment_sum(jnp.where(h2, x, 0.0), seg, nb)
        soc_blk = jax.ops.segment_sum(is_soc.astype(x.dtype), seg, nb) > 0
        rsoc_blk = jax.ops.segment_sum(is_rsoc.astype(x.dtype), seg, nb) > 0
        viol = jnp.maximum(viol, jnp.max(jnp.where(soc_blk, jnp.sqrt(bsq) - t0, 0.0)))
        viol = jnp.maximum(
            viol, jnp.max(jnp.where(rsoc_blk, bsq - 2.0 * t0 * t1, 0.0))
        )
    return viol


def cone_project(z: jnp.ndarray, layout: ConeLayout,
                 dual: bool = False) -> jnp.ndarray:
    """Euclidean projection Pi_K(z) (or onto the dual cone K* if dual).

    The barrier prox above is the INTERIOR regularized map the ADMM
    solver uses; this is the plain projection, needed by first-order
    competitors (restarted PDHG's x-update) and by the implicit-
    differentiation layer (`diff.dprojection_dense` is its Jacobian).

    Per block (self-dual blocks project identically under `dual`):
      free:   z            (dual cone of free is {0})
      zero:   0            (dual cone of {0} is free)
      nonneg: max(z, 0)
      SOC (t, u), nu = ||u||:  z if nu <= t;  0 if nu <= -t;
          else ((t+nu)/2) * (1, u/nu)                (Moreau three-branch)
      RSOC: conjugate by the orthogonal rotation H mapping
          (t1, t2) -> ((t1+t2)/sqrt2, (t1-t2)/sqrt2): Pi_R = H Pi_SOC H.
    """
    kind = jnp.asarray(layout.kind)
    free_k, zero_k = (_ZERO, _FREE) if dual else (_FREE, _ZERO)
    out = jnp.where(kind == _NONNEG, jnp.maximum(z, 0.0), z)
    out = jnp.where(kind == zero_k, 0.0, out)
    out = jnp.where(kind == free_k, z, out)
    if not layout.has_blocks:
        return out

    seg = jnp.asarray(layout.seg)
    nb = layout.num_blocks
    is_soc = jnp.asarray(layout.kind == _SOC)
    is_rsoc = jnp.asarray(layout.kind == _RSOC)
    h1 = jnp.asarray(layout.head == 1) & (is_soc | is_rsoc)
    h2 = jnp.asarray(layout.head == 2) & is_rsoc
    body = (is_soc | is_rsoc) & ~h1 & ~h2

    rt2 = jnp.sqrt(jnp.asarray(2.0, z.dtype))
    t1b = jax.ops.segment_sum(jnp.where(h1, z, 0.0), seg, nb)
    t2b = jax.ops.segment_sum(jnp.where(h2, z, 0.0), seg, nb)
    rsoc_blk = jax.ops.segment_sum(is_rsoc.astype(z.dtype), seg, nb) > 0
    # SOC head in rotated coordinates; the rotated RSOC "b" component
    # joins the body norm
    t_blk = jnp.where(rsoc_blk, (t1b + t2b) / rt2, t1b)
    b_rot = (t1b - t2b) / rt2
    bsq = jax.ops.segment_sum(jnp.where(body, z * z, 0.0), seg, nb)
    bsq = bsq + jnp.where(rsoc_blk, b_rot * b_rot, 0.0)
    nu = jnp.sqrt(bsq)

    keep = nu <= t_blk
    kill = nu <= -t_blk
    alpha = 0.5 * (t_blk + nu)
    head_out = jnp.where(keep, t_blk, jnp.where(kill, 0.0, alpha))
    fac = jnp.where(keep, 1.0,
                    jnp.where(kill, 0.0, alpha / jnp.maximum(nu, _TINY)))

    # scatter back per element
    out = jnp.where(body, z * fac[seg], out)
    b_out = b_rot * fac
    head1 = jnp.where(rsoc_blk, (head_out + b_out) / rt2, head_out)
    head2 = (head_out - b_out) / rt2
    out = jnp.where(h1, head1[seg], out)
    out = jnp.where(h2, head2[seg], out)
    return out
