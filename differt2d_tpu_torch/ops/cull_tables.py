"""Culling tables of the looped power-map kernels, as PyTorch ops.

Counterpart of the table builders of ``differt2d_tpu/ops/pallas_kernels.py``
that the city paths run (``B7`` in ROADMAP.md):

* :func:`first_wall_visibility_dead` -- exact per-first-wall occlusion kill;
* :func:`pair_occlusion_dead` -- exact per-wall-pair kill of middle
  segments (orders >= 2);
* :func:`beam_keep_tables` -- per-(tile, candidate) keep bits from the beam
  proof on ``refine x refine`` sub-boxes, plus both kills;
* :func:`_shadow_geometry`, :func:`_occluder_masks` and
  :func:`shadow_wall_lists` -- occluder sets of the first, last and
  line-of-sight path segments; :func:`mid_masks` those of middle segments
  (the mask ``mid_pair_masks`` packs into chunk words);
* :func:`_span_covered` -- union coverage of intervals (sort + cummax).

Each returns the JAX function's arrays in its layout, computed with the same
float32 operations in the same order, so the tests compare them directly.
The looped kernels read a repacked form: kept-first candidate lists and bit
words (:func:`keep_lists`, :func:`pack_words`).

Why skipping is exact.  A candidate's contribution at a pixel is exactly 0,
with both pixel partials exactly 0, wherever one of its factors saturates:
a bounce's ``contains`` (its wall parameter ``t`` beyond ``-z0/alpha`` or
``1 + z0/alpha``), or the blocked test (some wall's hit saturated at 1).  The
activations are flat there (``hard_sigmoid`` at ``|z| >= 3``; the kernels'
``1 / (1 + expf(-z))`` at ``z <= -90`` and ``z >= 20``, checked on the device
before sigmoid maps cull), so the min/max selects carry zeros.  The proofs
bound ``t`` over a tile box with interval arithmetic, backed off by the pads
``_CULL_PAD_ABS/REL`` against float32 rounding.  The interval occlusion
proofs are not ported.  Nor is the JAX package's 8-wall chunk-word form of
the occluder sets for orders >= 2 (``shadow_chunk_words``,
``mid_pair_masks``, with a list fallback above 256 walls): it answered the
TPU's compiler and scalar memory, and the kernels here read every set,
middle segments included, as per-wall bit words.
"""

from __future__ import annotations

import numpy as np
import torch

KIND_VERTEX = 2

_CULL_PAD_ABS = 1e-3
_CULL_PAD_REL = 1e-3
_SIGMOID_Z0 = 90.0
_SIGMOID_Z1 = 20.0
_HARD_Z = 3.0

# Elements of one [sub-boxes, tiles, candidates] slab of beam_keep_tables.
_BEAM_CHUNK = 1 << 24


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _bands(alpha, approx: bool, sigmoid: bool, device):
    """``(band0, band1)``: the saturated-0 and saturated-1 activation bands
    in wall-parameter units (0 under hard logic)."""
    if not approx:
        zero = _f32(0.0, device)
        return zero, zero
    alpha_f = torch.clamp_min(_f32(alpha, device), 1e-6)
    z0 = _SIGMOID_Z0 if sigmoid else _HARD_Z
    z1 = _SIGMOID_Z1 if sigmoid else _HARD_Z
    return z0 / alpha_f, z1 / alpha_f


def _sum2(v: torch.Tensor) -> torch.Tensor:
    """Sum over a last axis of 2, as ``v[..., 0] + v[..., 1]``."""
    return v[..., 0] + v[..., 1]


def _span_covered(starts, ends, span_lo, span_hi):
    """Whether the union of intervals covers ``[span_lo, span_hi]``,
    over leading axes (intervals on the last axis; empty ones as
    ``(inf, -inf)``).

    Sort by start and take the running reach ``R_k = max(span_lo,
    cummax(ends)_k)``: covered iff no interval starts beyond the reach while
    the reach is short of ``span_hi``, and the final reach passes it.
    """
    st, order = torch.sort(starts, dim=-1, stable=True)
    en = torch.gather(ends, -1, order)
    span_lo = _f32(span_lo, starts.device)
    reach = torch.maximum(torch.cummax(en, dim=-1).values, span_lo)
    prev = torch.cat(
        [span_lo.expand(*st.shape[:-1], 1), reach[..., :-1]], dim=-1
    )
    gap = torch.any((st > prev) & (prev < span_hi), dim=-1)
    return ~gap & (reach[..., -1] >= span_hi)


_FLT_MIN = 2.0 ** -126
"""Least normal float32: a wall whose squared length, as the kernels form
it, falls below it is listed everywhere (:func:`_shadow_geometry`)."""


def _shadow_geometry(walls32, kind, tx, patch, alpha, approx, sigmoid, tol):
    """Bounce-locus boxes ``llo/lhi`` (band-dilated walls), occluder boxes
    ``olo/ohi`` (patched, tol- and band-dilated walls), the occluder mask,
    the walls too short for the boxes (``short``, listed everywhere), the
    hull growth factors and the ``un == 0`` hazard gate ``hz_free``.

    Where a bounce's denominator ``(q - image) . n`` is exactly 0 the
    kernels pin ``b = q``, off the wall's locus; the outgoing segment then
    has zero length, the residual is 1, and the loss gate saturates to 0
    whenever ``alpha * (1 - tol)`` clears the activation's band.  Otherwise
    (tiny ``alpha``, huge ``tol``), or when a wall's line passes through the
    transmitter, ``hz_free`` is false and the lists fall back to every wall.
    """
    dev = walls32.device
    a = walls32[:, 0, :]
    b = walls32[:, 1, :]
    d = b - a
    if approx:
        z0 = _SIGMOID_Z0 if sigmoid else _HARD_Z
        band = z0 / torch.clamp_min(_f32(alpha, dev), 1e-6)
    else:
        band = _f32(0.0, dev)
    pad_t = 0.01
    abs_pad = 2e-3
    ext = 0.005 + band + pad_t

    la = a - (band + pad_t) * d
    lb = b + (band + pad_t) * d
    llo = torch.minimum(la, lb)
    lhi = torch.maximum(la, lb)

    p_f = _f32(patch, dev)
    pa = a - p_f * d
    pb = b + p_f * d
    dp = pb - pa
    oa = pa - ext * dp
    ob = pb + ext * dp
    olo = torch.minimum(oa, ob) - abs_pad
    ohi = torch.maximum(oa, ob) + abs_pad
    # A wall blocks unless it is a vertex or has a == b: a wall whose |d|^2
    # underflows to 0 still has a nonzero den in its blocked tests.
    occ_ok = (kind.to(torch.int32) != KIND_VERTEX) & ((d[:, 0] != 0.0) | (d[:, 1] != 0.0))
    # Walls too short for the boxes: |d|^2 or |dp|^2, formed as the kernels
    # form them, is not a normal float32.  As a bounce: the on-object test
    # divides (b - a) . d by |d|^2, by 1 where it underflows to 0, and with
    # a subnormal |d|^2 loses the relative accuracy that the locus box's
    # relative dilation (band + 0.01) covers, so bounces far off the box pass
    # it.  As an occluder: a blocked test's den and num_b are sums of
    # products of dp's components with O(1) differences, which lose precision
    # where those products leave the normal range.  Above the cut both tests
    # keep float32's relative accuracy and the boxes hold (up to nearly
    # collinear segments, ROADMAP open check 1), and the tables are the JAX
    # package's.  Such walls are listed for every segment, and the segments
    # that end on them list every wall.
    short = occ_ok & ((_sum2(d * d) < _FLT_MIN) | (_sum2(dp * dp) < _FLT_MIN))

    z_need = _SIGMOID_Z0 if (approx and sigmoid) else _HARD_Z
    tol_f = _f32(0.01 if tol is None else tol, dev)
    if approx:
        hz_free = _f32(alpha, dev) * (1.0 - tol_f - 0.02) >= (z_need + 1.0)
    else:
        hz_free = tol_f < 0.98
    tx32 = _f32(tx, dev)
    nrm = torch.stack([d[:, 1], -d[:, 0]], dim=-1)
    nlen = torch.sqrt(_sum2(nrm * nrm))
    tx_dist = torch.abs(_sum2((tx32[None, :] - a) * nrm))
    scale = torch.clamp_min(torch.max(torch.abs(walls32)), 1.0)
    wall_thru_tx = (nlen > 0.0) & (
        tx_dist <= 1e-4 * scale * torch.clamp_min(nlen, 1e-30)
    )
    hz_free = hz_free & ~torch.any(wall_thru_tx & occ_ok)
    return {
        "llo": llo, "lhi": lhi, "olo": olo, "ohi": ohi, "occ_ok": occ_ok,
        "short": short, "ext": ext, "abs_pad": abs_pad, "hz_free": hz_free,
    }


def first_wall_visibility_dead(walls32, kind, tx, patch, alpha, approx, sigmoid, tol):
    """Exact per-first-wall occlusion kill ``dead[W]`` (bool).

    ``dead[i]``: every candidate whose first wall is ``i`` contributes exact
    zeros at every pixel.  Its first segment runs TX -> b1 with b1 on wall
    ``i``'s line; each eligible blocker, shrunk to the part where a crossing
    saturates the hit at 1, casts a shadow interval on that line (its
    endpoints' projections from TX, exact because the crossing ratio is
    affine along a straight blocker), and the union of the pad-shrunk
    shadows covers the pad-grown span where ``contains`` is nonzero.
    Vertex and zero-length first walls are never killed; under the hazard
    gate nothing is.
    """
    dev = walls32.device
    W = walls32.shape[0]
    a = walls32[:, 0, :]
    b = walls32[:, 1, :]
    d = b - a
    dd = _sum2(d * d)
    tx32 = _f32(tx, dev)
    kind_i32 = kind.to(torch.int32)
    band0, band1 = _bands(alpha, approx, sigmoid, dev)
    seg_tol = 0.005
    pad_t = 0.01
    pad = _CULL_PAD_ABS + _CULL_PAD_REL * (1.0 + band0)
    span_lo = -(band0 + pad_t) - pad
    span_hi = 1.0 + band0 + pad_t + pad

    p_f = _f32(patch, dev)
    aw = a - p_f * d
    av = (b + p_f * d) - aw
    blo = band1 - seg_tol + pad
    bhi = 1.0 + seg_tol - band1 - pad
    p1 = aw + blo * av
    p2 = aw + bhi * av
    blocker_ok = (kind_i32 != KIND_VERTEX) & (dd > 0.0) & (bhi > blo)

    n_i = torch.stack([d[:, 1], -d[:, 0]], dim=-1)
    scale = torch.clamp_min(torch.max(torch.abs(walls32)), 1.0)
    scale = torch.maximum(scale, torch.max(torch.abs(tx32)))
    floor = 1e-4 * scale * scale

    a_n = _sum2(a * n_i)[:, None]
    s_p1 = (p1[None, :, 0] * n_i[:, None, 0] + p1[None, :, 1] * n_i[:, None, 1]) - a_n
    s_p2 = (p2[None, :, 0] * n_i[:, None, 0] + p2[None, :, 1] * n_i[:, None, 1]) - a_n
    s_tx = _sum2((tx32[None, :] - a) * n_i)
    sg = torch.sign(s_tx)[:, None]
    tx_ok = torch.abs(s_tx) > floor
    side_ok = (s_p1 * sg > floor) & (s_p2 * sg > floor)

    s_tx_safe = torch.where(tx_ok, s_tx, torch.ones_like(s_tx))[:, None]
    lam1 = 1.0 - s_p1 / s_tx_safe
    lam2 = 1.0 - s_p2 / s_tx_safe
    lam_margin = 1e-3
    lam_lo = torch.clamp_min(band1 - seg_tol + pad, lam_margin)
    lam_hi = torch.clamp_max(1.0 + seg_tol - band1 - pad, 1.0 - lam_margin)
    lam_ok = (lam1 > lam_lo) & (lam1 < lam_hi) & (lam2 > lam_lo) & (lam2 < lam_hi)

    dd_safe = torch.where(dd > 0.0, dd, torch.ones_like(dd))[:, None]

    def t_of(p, s_p):
        den = s_tx[:, None] - s_p
        den = torch.where(torch.abs(den) > 0.0, den, torch.ones_like(den))
        u = s_tx[:, None] / den
        q = tx32[None, None, :] + u[..., None] * (p[None, :, :] - tx32[None, None, :])
        qa = q - a[:, None, :]
        return (qa[..., 0] * d[:, None, 0] + qa[..., 1] * d[:, None, 1]) / dd_safe

    t1 = t_of(p1, s_p1)
    t2 = t_of(p2, s_p2)
    rng = torch.arange(W, device=dev)
    valid_iv = (
        blocker_ok[None, :] & side_ok & lam_ok & tx_ok[:, None]
        & (rng[None, :] != rng[:, None])
    )
    t_pad = _CULL_PAD_ABS + _CULL_PAD_REL * torch.maximum(torch.abs(t1), torch.abs(t2))
    inf = torch.full_like(t1, float("inf"))
    starts = torch.where(valid_iv, torch.minimum(t1, t2) + t_pad, inf)
    ends = torch.where(valid_iv, torch.maximum(t1, t2) - t_pad, -inf)
    dead = _span_covered(starts, ends, span_lo, span_hi)
    dead = dead & (kind_i32 != KIND_VERTEX) & (dd > 0.0)
    geo = _shadow_geometry(walls32, kind, tx, patch, alpha, approx, sigmoid, tol)
    return dead & geo["hz_free"]


# Lanes of one [downstream walls, upstream walls, blockers] slab of
# pair_occlusion_dead.
_PAIR_CHUNK = 1 << 22


def pair_occlusion_dead(walls32, kind, tx, patch, alpha, approx, sigmoid, tol):
    """Exact per-(upstream, downstream)-wall kill ``dead[W, W]`` (bool) for
    middle path segments.

    ``dead[i, j]``: every candidate with consecutive walls ``(i, j)``
    contributes exact zeros at every pixel.  The middle segment runs from
    wall ``i``'s pad-grown contains span to wall ``j``'s line; each blocker
    casts, from each of the span's two endpoints, a shadow interval on wall
    ``j`` (:func:`first_wall_visibility_dead`'s projection with the
    transmitter replaced by the endpoint), and the crossing ratio is affine
    in the source and the blocker point, so its extremes over span x
    blocker lie at the four endpoint pairs.  A blocker whose four ratios
    are strictly in band casts the intersection of its two intervals, and
    ``dead[i, j]`` iff their union covers wall ``j``'s span.  Pairs with a
    vertex or zero-length wall are never killed; under the hazard gate
    nothing is.  One ``[W, W, W]`` sweep, in slabs of downstream walls.
    """
    dev = walls32.device
    W = walls32.shape[0]
    a = walls32[:, 0, :]
    b = walls32[:, 1, :]
    d = b - a
    dd = _sum2(d * d)
    kind_i32 = kind.to(torch.int32)
    band0, band1 = _bands(alpha, approx, sigmoid, dev)
    seg_tol = 0.005
    pad_t = 0.01
    pad = _CULL_PAD_ABS + _CULL_PAD_REL * (1.0 + band0)
    span_lo = -(band0 + pad_t) - pad
    span_hi = 1.0 + band0 + pad_t + pad

    S1 = a + span_lo * d
    S2 = a + span_hi * d
    p_f = _f32(patch, dev)
    aw = a - p_f * d
    av = (b + p_f * d) - aw
    blo = band1 - seg_tol + pad
    bhi = 1.0 + seg_tol - band1 - pad
    P1 = aw + blo * av
    P2 = aw + bhi * av
    wall_usable = (kind_i32 != KIND_VERTEX) & (dd > 0.0)
    blocker_ok = wall_usable & (bhi > blo)

    n_j = torch.stack([d[:, 1], -d[:, 0]], dim=-1)
    a_dot_n = _sum2(a * n_j)
    scale = torch.clamp_min(torch.max(torch.abs(walls32)), 1.0)
    floor = 1e-4 * scale * scale

    def dots(q, v):  # [W_q, 2] x [W_j, 2] -> [W_j, W_q], as a 2-term einsum
        return q[None, :, 0] * v[:, None, 0] + q[None, :, 1] * v[:, None, 1]

    s_S1 = dots(S1, n_j) - a_dot_n[:, None]  # [W_j, W_i]
    s_S2 = dots(S2, n_j) - a_dot_n[:, None]
    s_P1 = dots(P1, n_j) - a_dot_n[:, None]  # [W_j, W_k]
    s_P2 = dots(P2, n_j) - a_dot_n[:, None]
    src_ok = (torch.abs(s_S1) > floor) & (torch.abs(s_S2) > floor) & (s_S1 * s_S2 > 0.0)

    lam_margin = 1e-3
    lam_lo = torch.clamp_min(band1 - seg_tol + pad, lam_margin)
    lam_hi = torch.clamp_max(1.0 + seg_tol - band1 - pad, 1.0 - lam_margin)
    inv_dd = 1.0 / torch.where(dd > 0.0, dd, torch.ones_like(dd))
    ad = _sum2(a * d)
    Sd1, Sd2 = dots(S1, d), dots(S2, d)  # [W_j, W_i] = S . d_j
    Pd1, Pd2 = dots(P1, d), dots(P2, d)  # [W_j, W_k]
    rng = torch.arange(W, device=dev)
    not_i = rng[None, :] != rng[:, None]  # [W_i, W_k]

    def lam(s_src, s_p):
        safe = torch.where(torch.abs(s_src) > floor, s_src, torch.ones_like(s_src))
        return 1.0 - s_p / safe

    def t_proj(Sd, s_S, Pd, s_p, js):  # [W_j, W_i, W_k] parameters on wall j
        den = s_S[:, :, None] - s_p[:, None, :]
        den = torch.where(torch.abs(den) > 0.0, den, torch.ones_like(den))
        u = s_S[:, :, None] / den
        qd = Sd[js][:, :, None] + u * (Pd[js][:, None, :] - Sd[js][:, :, None])
        return (qd - ad[js][:, None, None]) * inv_dd[js][:, None, None]

    dead_ji = []
    step = max(1, _PAIR_CHUNK // max(W * W, 1))
    for j0 in range(0, W, step):
        js = slice(j0, min(j0 + step, W))
        sS1, sS2, sP1, sP2 = s_S1[js], s_S2[js], s_P1[js], s_P2[js]
        sgi = torch.sign(sS1)[:, :, None]
        side_ok = (sP1[:, None, :] * sgi > floor) & (sP2[:, None, :] * sgi > floor)
        lam_ok = torch.ones_like(side_ok)
        for src, blk in ((sS1, sP1), (sS1, sP2), (sS2, sP1), (sS2, sP2)):
            lv = lam(src[:, :, None], blk[:, None, :])
            lam_ok = lam_ok & (lv > lam_lo) & (lv < lam_hi)
        tA1 = t_proj(Sd1, sS1, Pd1, sP1, js)
        tA2 = t_proj(Sd1, sS1, Pd2, sP2, js)
        tB1 = t_proj(Sd2, sS2, Pd1, sP1, js)
        tB2 = t_proj(Sd2, sS2, Pd2, sP2, js)
        lo = torch.maximum(torch.minimum(tA1, tA2), torch.minimum(tB1, tB2))
        hi = torch.minimum(torch.maximum(tA1, tA2), torch.maximum(tB1, tB2))
        t_pad = _CULL_PAD_ABS + _CULL_PAD_REL * torch.maximum(torch.abs(lo), torch.abs(hi))
        rj = rng[js]
        valid_iv = (
            side_ok & lam_ok & src_ok[js][:, :, None] & blocker_ok[None, None, :]
            & wall_usable[None, :, None] & wall_usable[js][:, None, None]
            & not_i[None, :, :] & (rng[None, None, :] != rj[:, None, None])
        )
        starts = torch.where(valid_iv, lo + t_pad, torch.full_like(lo, float("inf")))
        ends = torch.where(valid_iv, hi - t_pad, torch.full_like(hi, -float("inf")))
        dead_ji.append(_span_covered(starts, ends, span_lo, span_hi))
    dead = torch.cat(dead_ji).T if W else torch.zeros(0, 0, dtype=torch.bool, device=dev)
    geo = _shadow_geometry(walls32, kind, tx, patch, alpha, approx, sigmoid, tol)
    return dead & geo["hz_free"]


def _ival(F, bx0, bx1, by0, by1):
    """Interval of the affine form ``F = (F0, Fx, Fy)`` (each ``[C]``) over
    boxes (each ``[B]``): ``([B, C], [B, C])``."""
    F0, Fx, Fy = F
    xa = Fx[None, :] * bx0[:, None]
    xb = Fx[None, :] * bx1[:, None]
    ya = Fy[None, :] * by0[:, None]
    yb = Fy[None, :] * by1[:, None]
    flo = F0[None, :] + torch.minimum(xa, xb) + torch.minimum(ya, yb)
    fhi = F0[None, :] + torch.maximum(xa, xb) + torch.maximum(ya, yb)
    return flo, fhi


def _idiv(N, D):
    """Interval quotient; the caller masks lanes where ``D`` straddles 0."""
    nlo, nhi = N
    dlo, dhi = D
    sa = torch.where(dlo == 0.0, torch.ones_like(dlo), dlo)
    sb = torch.where(dhi == 0.0, torch.ones_like(dhi), dhi)
    q = torch.stack([nlo / sa, nlo / sb, nhi / sa, nhi / sb])
    return torch.amin(q, dim=0), torch.amax(q, dim=0)


def _pad_outside(iv, lo_cut, hi_cut):
    lo, hi = iv
    pad = _CULL_PAD_ABS + _CULL_PAD_REL * torch.maximum(torch.abs(lo), torch.abs(hi))
    return (hi + pad < lo_cut) | (lo - pad > hi_cut)


def beam_keep_tables(
    walls32, normals32, kind, groups: dict, cand_orders, img_chains: dict,
    x0, x1, y0, y1, *, approx: bool, alpha, tx=None, patch=None,
    refine: int = 4, sigmoid: bool = False, tol=None,
):
    """Per-(tile, candidate) keep bits of tile-beam culling.

    The kernels' backward image recursion makes each bounce point a
    projective-affine function of the pixel, so each bounce's wall
    parameter is a ratio of two affine forms, bounded over a box by
    interval arithmetic where the denominator is sign-definite (with a
    margin against the ``un == 0`` guard).  A candidate is dropped from a
    tile when, on every one of the ``refine x refine`` sub-boxes of the
    tile, some non-vertex bounce's parameter lies (pad-widened) outside the
    band where ``contains`` is nonzero, or when its first wall is dead
    (:func:`first_wall_visibility_dead`, given ``tx`` and ``tol``), or when
    two of its consecutive walls form a dead pair
    (:func:`pair_occlusion_dead`, at orders >= 2).

    ``groups`` maps orders to ``int32[C, order]``, ``img_chains`` orders to
    the transmitter's mirror-image chains ``[C, order, 2]``, and the tile
    boxes are ``x0, x1, y0, y1`` (each ``[T]``).

    :return: ``{order: keep[T, C] bool}`` for each order of ``cand_orders``.
    """
    dev = walls32.device
    kind_i32 = kind.to(torch.int32)
    band0, _ = _bands(alpha, approx, sigmoid, dev)
    lo_thr = -band0
    hi_thr = 1.0 + band0

    R = max(1, int(refine))
    T = x0.shape[0]
    fr = torch.arange(R, dtype=torch.float32, device=dev) / R
    gx0 = x0[None, :] + (x1 - x0)[None, :] * fr[:, None]
    gx1 = gx0 + (x1 - x0)[None, :] / R
    gy0 = y0[None, :] + (y1 - y0)[None, :] * fr[:, None]
    gy1 = gy0 + (y1 - y0)[None, :] / R
    sub_x0 = torch.repeat_interleave(gx0, R, dim=0)  # x varies slowly
    sub_x1 = torch.repeat_interleave(gx1, R, dim=0)
    sub_y0 = gy0.repeat(R, 1)
    sub_y1 = gy1.repeat(R, 1)

    first_dead = pair_dead = None
    if tx is not None and tol is not None:
        patch_f = 0.0 if patch is None else patch
        first_dead = first_wall_visibility_dead(
            walls32, kind, tx, patch_f, alpha, approx, sigmoid, tol
        )
        if any(o >= 2 for o in cand_orders):
            pair_dead = pair_occlusion_dead(
                walls32, kind, tx, patch_f, alpha, approx, sigmoid, tol
            )

    keep_by_order = {}
    for o in cand_orders:
        cand = torch.as_tensor(np.array(groups[o], dtype=np.int64), device=dev)
        C = cand.shape[0]
        zeros_c = torch.zeros(C, dtype=torch.float32, device=dev)
        ones_c = torch.ones(C, dtype=torch.float32, device=dev)
        # Phase 1 (box-independent): affine coefficient triples of each
        # path point and each bounce's (num, den) forms.
        vx = (zeros_c, ones_c, zeros_c)
        vy = (zeros_c, zeros_c, ones_c)
        w = (ones_c, zeros_c, zeros_c)
        bounce_tests = []
        imgs = img_chains[o]
        for j in range(o - 1, -1, -1):
            li = cand[:, j]
            a_pt = walls32[li, 0, :]
            b_pt = walls32[li, 1, :]
            d = b_pt - a_pt
            nv = normals32[li]
            dd = _sum2(d * d)
            img = imgs[:, j, :]
            c_c = _sum2((a_pt - img) * nv)
            k1 = _sum2((img - a_pt) * d)
            i_n = _sum2(img * nv)
            i_d = _sum2(img * d)
            u = tuple(vx[t] * nv[:, 0] + vy[t] * nv[:, 1] - w[t] * i_n for t in range(3))
            av = tuple(vx[t] * d[:, 0] + vy[t] * d[:, 1] - w[t] * i_d for t in range(3))
            num = tuple(k1 * u[t] + c_c * av[t] for t in range(3))
            den = tuple(dd * u[t] for t in range(3))
            is_vtx_c = kind_i32[li] == KIND_VERTEX
            bounce_tests.append((num, den, is_vtx_c, dd > 0.0, dd))
            vx, vy, w = (
                tuple(
                    torch.where(is_vtx_c, a_pt[:, 0] * w[t],
                                img[:, 0] * u[t] + c_c * (vx[t] - w[t] * img[:, 0]))
                    for t in range(3)
                ),
                tuple(
                    torch.where(is_vtx_c, a_pt[:, 1] * w[t],
                                img[:, 1] * u[t] + c_c * (vy[t] - w[t] * img[:, 1]))
                    for t in range(3)
                ),
                tuple(torch.where(is_vtx_c, w[t], u[t]) for t in range(3)),
            )

        # Coordinate scale of the kernels' un evaluation for this order.
        img_max = torch.max(torch.abs(imgs)) if imgs.numel() else _f32(0.0, dev)
        m = torch.maximum(
            torch.max(torch.abs(walls32)),
            torch.maximum(
                img_max,
                torch.maximum(torch.max(torch.abs(x0)), torch.max(torch.abs(y1))),
            ),
        )
        scale2 = m * m

        # Phase 2: per sub-box, prove the candidate contributes exact
        # zeros; AND over the sub-boxes of each tile.
        zero = torch.ones(T, C, dtype=torch.bool, device=dev)
        gb = max(1, min(R * R, _BEAM_CHUNK // max(T * C, 1)))
        for start in range(0, R * R, gb):
            sl = slice(start, min(start + gb, R * R))
            nb = sl.stop - sl.start
            bx0, bx1, by0, by1 = (
                s[sl].reshape(-1) for s in (sub_x0, sub_x1, sub_y0, sub_y1)
            )
            B = bx0.shape[0]
            culled = torch.zeros(B, C, dtype=torch.bool, device=dev)
            alive = torch.ones(B, C, dtype=torch.bool, device=dev)
            for num, den, is_vtx_c, dd_ok, dd in bounce_tests:
                nlo, nhi = _ival(num, bx0, bx1, by0, by1)
                dlo, dhi = _ival(den, bx0, bx1, by0, by1)
                # Denominators must clear zero by ~100x the float32 error
                # of the kernels' un (~1e-7 scale^2, times |d|^2 here).
                padd = 1e-5 * scale2 * dd[None, :] + 1e-5 * torch.maximum(
                    torch.abs(dlo), torch.abs(dhi)
                )
                sign_def = ((dlo > padd) | (dhi < -padd)) & dd_ok[None, :]
                t_iv = _idiv((nlo, nhi), (dlo, dhi))
                out_of_band = _pad_outside(t_iv, lo_thr, hi_thr)
                is_vtx = is_vtx_c[None, :]
                culled = culled | (alive & sign_def & out_of_band & ~is_vtx)
                alive = alive & (sign_def | is_vtx)
            zero &= culled.reshape(nb, T, C).all(dim=0)
        if first_dead is not None and o >= 1:
            zero = zero | first_dead[cand[:, 0]][None, :]
        if pair_dead is not None:
            for s in range(1, o):
                zero = zero | pair_dead[cand[:, s - 1], cand[:, s]][None, :]
        keep_by_order[o] = ~zero
    return keep_by_order


def _hull_mask(geo, hlo, hhi):
    """``[..., W]``: which occluder boxes meet the grown hulls ``[..., 2]``."""
    olo, ohi = geo["olo"], geo["ohi"]
    diag = torch.sqrt(_sum2((hhi - hlo) * (hhi - hlo)))[..., None]
    grow = geo["ext"] * diag + geo["abs_pad"]
    glo = hlo - grow
    ghi = hhi + grow
    overlap = ~(
        (ohi[:, 0] < glo[..., 0][..., None])
        | (olo[:, 0] > ghi[..., 0][..., None])
        | (ohi[:, 1] < glo[..., 1][..., None])
        | (olo[:, 1] > ghi[..., 1][..., None])
    )
    return (overlap | geo["short"]) & geo["occ_ok"]


def first_masks(geo, tx) -> torch.Tensor:
    """``m0[W, W]``: occluders of the first segment, per first wall (hull of
    TX and the dilated wall, the wall itself excluded)."""
    tx32 = _f32(tx, geo["llo"].device)
    W = geo["llo"].shape[0]
    h0lo = torch.minimum(tx32[None, :], geo["llo"])
    h0hi = torch.maximum(tx32[None, :], geo["lhi"])
    rng = torch.arange(W, device=tx32.device)
    mask = _hull_mask(geo, h0lo, h0hi) | geo["short"][:, None]
    return mask & geo["occ_ok"][None, :] & (rng[None, :] != rng[:, None])


def last_masks(geo, x0, x1, y0, y1) -> torch.Tensor:
    """``mlast[T, W, W]``: occluders of the last segment, per tile and last
    wall (hull of the tile box and the dilated wall, the wall excluded)."""
    W = geo["llo"].shape[0]
    tlo = torch.stack([x0, y0], dim=-1)
    thi = torch.stack([x1, y1], dim=-1)
    hllo = torch.minimum(tlo[:, None, :], geo["llo"][None, :, :])
    hlhi = torch.maximum(thi[:, None, :], geo["lhi"][None, :, :])
    rng = torch.arange(W, device=x0.device)
    mask = _hull_mask(geo, hllo, hlhi) | geo["short"][None, :, None]
    return mask & geo["occ_ok"] & (rng[None, :] != rng[:, None])[None]


def mid_masks(geo, upstream=slice(None)) -> torch.Tensor:
    """``mmid[I, W, W]``: occluders of a middle segment, per upstream wall
    ``i`` (those of ``upstream``) and downstream wall ``j`` (hull of the two
    dilated walls, both walls excluded); every wall under the hazard gate.

    The segment b_s -> b_{s+1} of an order >= 2 candidate lies in that hull
    wherever both bounces' ``contains`` are nonzero, so the argument of
    :func:`shadow_wall_lists` holds per wall pair, for every tile.
    """
    llo, lhi = geo["llo"], geo["lhi"]
    W = llo.shape[0]
    rng = torch.arange(W, device=llo.device)
    up = rng[upstream]
    hlo = torch.minimum(llo[up][:, None, :], llo[None, :, :])
    hhi = torch.maximum(lhi[up][:, None, :], lhi[None, :, :])
    short = geo["short"]
    mask = _hull_mask(geo, hlo, hhi) | short[up][:, None, None] | short[None, :, None]
    mask = (mask & geo["occ_ok"] & (rng[None, None, :] != up[:, None, None])
            & (rng[None, None, :] != rng[None, :, None]))
    return torch.where(geo["hz_free"], mask, torch.ones_like(mask))


# Elements of one [upstream walls, W, W] slab of mid_words.
_MID_SLAB = 1 << 24


def mid_words(geo) -> torch.Tensor:
    """:func:`mid_masks` of every wall pair in the kernels' form:
    ``int32[W * W, ceil(W / 32)]``, row ``i * W + j``."""
    W = geo["llo"].shape[0]
    step = max(1, _MID_SLAB // max(W * W, 1))
    words = [pack_words(mid_masks(geo, slice(s, s + step))) for s in range(0, W, step)]
    if not words:
        return torch.zeros(0, 0, dtype=torch.int32, device=geo["llo"].device)
    return torch.cat(words).reshape(W * W, -1)


def los_masks(geo, tx, x0, x1, y0, y1) -> torch.Tensor:
    """``mlos[T, W]``: occluders of the line of sight, per tile (hull of TX
    and the tile box)."""
    tx32 = _f32(tx, x0.device)
    hslo = torch.minimum(tx32[None, :], torch.stack([x0, y0], dim=-1))
    hshi = torch.maximum(tx32[None, :], torch.stack([x1, y1], dim=-1))
    return _hull_mask(geo, hslo, hshi)


def _occluder_masks(walls32, kind, tx, patch, alpha, approx, x0, x1, y0, y1,
                    sigmoid=False, tol=None, geo=None):
    """``(geo, m0[W, W], mlast[T, W, W], mlos[T, W])``: entry ``[..., w]``
    says wall ``w`` can meet the segment's hull.

    Off these sets a wall's hit is exactly 0 wherever the bounce lies on
    its band-dilated wall, and where it does not, ``contains`` is exactly 0
    with zero partials, so the candidate's value and partials do not depend
    on that wall (see :func:`shadow_wall_lists`).
    """
    if geo is None:
        geo = _shadow_geometry(walls32, kind, tx, patch, alpha, approx, sigmoid, tol)
    return (geo, first_masks(geo, tx), last_masks(geo, x0, x1, y0, y1),
            los_masks(geo, tx, x0, x1, y0, y1))


def shadow_wall_lists(walls32, kind, tx, patch, alpha, approx, x0, x1, y0, y1,
                      sigmoid=False, tol=None):
    """Occluder index lists (survivors first, in index order) and counts.

    The first segment TX -> b1 lies in the hull of TX and the dilated first
    wall wherever ``contains`` is nonzero, the last b1 -> pixel in the hull
    of the tile and the dilated last wall, the line of sight in the hull of
    TX and the tile; a wall whose dilated box misses the grown hull cannot
    hit the segment.  Under the hazard gate the first and last lists hold
    every wall (the line of sight has no bounce and no gate).

    :return: ``(l0dat[W*W], l0cnt[W], lastdat[T, W, W], lastcnt[T, 1, W],
        losdat[T, 1, W], loscnt[T, 1, 1])`` int32.
    """
    W = walls32.shape[0]
    geo, m0, mlast, mlos = _occluder_masks(
        walls32, kind, tx, patch, alpha, approx, x0, x1, y0, y1,
        sigmoid=sigmoid, tol=tol,
    )
    hz_free = geo["hz_free"]

    def to_list(mask):
        prm = torch.sort((~mask).to(torch.uint8), dim=-1, stable=True).indices
        return prm.to(torch.int32), mask.sum(dim=-1).to(torch.int32)

    def gate(dat, cnt):
        ident = torch.arange(W, dtype=torch.int32, device=dat.device).expand(dat.shape)
        return (torch.where(hz_free, dat, ident),
                torch.where(hz_free, cnt, torch.full_like(cnt, W)))

    l0dat, l0cnt = gate(*to_list(m0))
    ldat, lcnt = gate(*to_list(mlast))
    sdat, scnt = to_list(mlos)
    return (l0dat.reshape(-1), l0cnt, ldat, lcnt[:, None, :], sdat[:, None, :],
            scnt[:, None, None])


# -- the kernels' form ---------------------------------------------------------


def pack_words(mask: torch.Tensor) -> torch.Tensor:
    """``[..., W]`` bool -> ``int32[..., ceil(W / 32)]``: bit ``b`` of word
    ``k`` is ``mask[..., 32 k + b]`` (bit 31 is the sign bit; distinct
    bits add without carries, so an int32 sum is exact)."""
    W = mask.shape[-1]
    nw = -(-W // 32)
    padded = torch.nn.functional.pad(mask.to(torch.int32), (0, 32 * nw - W))
    shifts = torch.arange(32, dtype=torch.int32, device=mask.device)
    bits = torch.bitwise_left_shift(padded.reshape(*mask.shape[:-1], nw, 32), shifts)
    return bits.sum(dim=-1, dtype=torch.int32)


def unpack_words(words: torch.Tensor, W: int) -> torch.Tensor:
    """Inverse of :func:`pack_words`: ``[..., W]`` bool."""
    bits = torch.bitwise_right_shift(
        words.to(torch.int64)[..., None] & 0xFFFFFFFF,
        torch.arange(32, dtype=torch.int64, device=words.device),
    ) & 1
    return bits.reshape(*words.shape[:-1], -1)[..., :W].to(torch.bool)


def keep_lists(keep: torch.Tensor):
    """``keep[T, C]`` -> ``(prm int32[T, C], cnt int32[T])``: each tile's
    kept candidates first, in index order, and their count."""
    prm = torch.sort((~keep).to(torch.uint8), dim=1, stable=True).indices
    return prm.to(torch.int32).contiguous(), keep.sum(dim=1).to(torch.int32)
