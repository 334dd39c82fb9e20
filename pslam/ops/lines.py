"""Line-segment detection as a batched tile/structure-tensor program.

Replaces the reference's LSD detector + EDLines (Thirdparty/line_descriptor,
add_src/LineExtractor.cpp:325-366) and the collinear-merge post-pass
(add_src/uselongline.cpp:24-336, optimizeAndMergeLines_lsd :449) with a
a data-parallel design: LSD's sequential region growing is hostile to XLA, so we
invert the algorithm — fixed tiles each propose at most one segment from
their gradient structure tensor, and a fixed number of masked pairwise merge
passes glue tile fragments into full segments. Same goal (gradient-aligned
segments with sub-tile precision, response-ranked, fixed budget), no
data-dependent control flow:

1. gradients for every pixel (one conv);
2. per-tile weighted structure tensor over magnitude-thresholded pixels;
   principal direction = closed-form 2x2 eigenvector; a tile proposes a
   segment if its support fraction, anisotropy, and straightness pass;
3. endpoints = extremal projections of supporting pixels on the principal
   axis through the weighted centroid;
4. merge: the (T, T) "collinear + adjacent" matrix is computed in one shot;
   each surviving segment absorbs every weaker segment that points at it as
   its best absorber; O(log chain) passes replace uselongline's
   while-loop merge (MergeLines semantics: angle gap, perpendicular offset,
   endpoint gap thresholds);
5. top-K by length into a fixed-capacity SoA (the reference sorts by
   response and truncates to nLSDFeature, LineExtractor.cpp:341-347).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class LineConfig:
    n_lines: int = 128  # capacity (reference nFeatures=200, TUM1.yaml:56)
    tile: int = 16
    mag_thr: float = 12.0  # gradient magnitude threshold (LSD rho ~ 2/sin(tol))
    align_tol: float = 0.3927  # orientation tolerance, 22.5 deg (LSD default)
    min_support_frac: float = 0.045  # of tile pixels
    max_perp_spread: float = 1.2  # px RMS across-line spread (straightness)
    min_len: float = 18.0  # final min segment length (min_line_length,
    # LineExtractor.h ctor: 0.025*min(H,W) ~ 12 at 480p; merged lines only)
    merge_passes: int = 4
    merge_angle: float = 0.06  # rad (~3.5 deg), uselongline angle gate
    merge_perp: float = 2.0  # px midpoint-to-line offset
    merge_gap: float = 24.0  # px endpoint gap along the direction (tiles that
    # propose nothing leave <= ~1.5-tile holes; phase-2 tiling covers most)


class LineFeatures(NamedTuple):
    """SoA line-segment set (fixed capacity NL)."""

    sp: jnp.ndarray  # (NL, 2) start point (x, y)
    ep: jnp.ndarray  # (NL, 2) end point (x, y)
    angle: jnp.ndarray  # (NL,) canonical direction angle in (-pi, pi]
    # (endpoints are gradient-polarity ordered, so the angle is stable)
    length: jnp.ndarray  # (NL,)
    eq2d: jnp.ndarray  # (NL, 3) image-line equation sp x ep, normalized so
    # that sqrt(a^2+b^2) = 1 (Frame.cc:520-528 mvle_l convention)
    response: jnp.ndarray  # (NL,) mean supporting gradient magnitude
    valid: jnp.ndarray  # (NL,) bool


def image_gradients(img):
    """Central-difference gradients (gx, gy) of an (H, W) image."""
    gx = 0.5 * (jnp.roll(img, -1, axis=-1) - jnp.roll(img, 1, axis=-1))
    gy = 0.5 * (jnp.roll(img, -1, axis=-2) - jnp.roll(img, 1, axis=-2))
    # Zero a 2px border: kills roll wrap-around and image-boundary edges.
    h, w = img.shape[-2:]
    ys = jnp.arange(h)
    xs = jnp.arange(w)
    interior = (
        ((ys >= 2) & (ys < h - 2))[:, None] & ((xs >= 2) & (xs < w - 2))[None, :]
    )
    return gx * interior, gy * interior


def _tile_candidates(img, cfg: LineConfig, offset: int = 0):
    """Per-tile segment proposals over the tiling shifted by ``offset`` px in
    both axes (a second half-tile phase covers segments that straddle the
    phase-0 tile boundaries). Returns SoA over T = (H'//t)*(W'//t) tiles."""
    gx, gy = image_gradients(img)
    if offset:
        gx = gx[offset:, offset:]
        gy = gy[offset:, offset:]
    h, w = gx.shape
    t = cfg.tile
    ny, nx = h // t, w // t

    def tiles(a):
        return (
            a[: ny * t, : nx * t]
            .reshape(ny, t, nx, t)
            .transpose(0, 2, 1, 3)
            .reshape(ny * nx, t * t)
        )

    gxx, gyy, gxy = tiles(gx * gx), tiles(gy * gy), tiles(gx * gy)
    mag2 = gxx + gyy
    strong = mag2 > cfg.mag_thr**2  # (T, t*t)

    wgt = jnp.where(strong, mag2, 0.0)
    sxx = jnp.sum(jnp.where(strong, gxx, 0.0), axis=1)
    syy = jnp.sum(jnp.where(strong, gyy, 0.0), axis=1)
    sxy = jnp.sum(jnp.where(strong, gxy, 0.0), axis=1)

    # Principal gradient direction of the 2x2 structure tensor [sxx sxy; sxy
    # syy]; the LINE direction is perpendicular to it. theta_grad =
    # 0.5*atan2(2sxy, sxx - syy).
    theta_g = 0.5 * jnp.arctan2(2.0 * sxy, sxx - syy)
    line_dir = jnp.stack([-jnp.sin(theta_g), jnp.cos(theta_g)], axis=-1)  # (T, 2)

    # Eigenvalues for anisotropy: lam = (tr +- sqrt((sxx-syy)^2+4sxy^2))/2.
    tr = sxx + syy
    root = jnp.sqrt((sxx - syy) ** 2 + 4.0 * sxy * sxy + 1e-12)
    lam1 = 0.5 * (tr + root)
    lam2 = 0.5 * (tr - root)
    aniso = lam1 / jnp.maximum(tr, 1e-9)  # in [0.5, 1]

    # Support: strong pixels whose gradient is aligned with the dominant
    # gradient direction (level-line alignment, LSD's region criterion).
    ca, sa = jnp.cos(theta_g)[:, None], jnp.sin(theta_g)[:, None]
    gxt, gyt = tiles(gx), tiles(gy)
    along = gxt * ca + gyt * sa
    cross = -gxt * sa + gyt * ca
    align = jnp.abs(jnp.arctan2(cross, jnp.abs(along))) < cfg.align_tol
    support = strong & align
    n_sup = jnp.sum(support, axis=1)
    wsup = jnp.where(support, wgt, 0.0)
    wsum = jnp.maximum(jnp.sum(wsup, axis=1), 1e-9)

    # Pixel coordinates within the canvas.
    yy, xx = np.mgrid[0:t, 0:t]
    px_local = jnp.asarray(
        np.stack([xx.reshape(-1), yy.reshape(-1)], axis=-1), jnp.float32
    )  # (t*t, 2)
    ty, tx = np.divmod(np.arange(ny * nx), nx)
    origin = jnp.asarray(
        np.stack([tx * t + offset, ty * t + offset], axis=-1).astype(np.float32)
    )  # (T, 2)
    pix = origin[:, None, :] + px_local[None, :, :]  # (T, t*t, 2)

    cen = jnp.sum(wsup[..., None] * pix, axis=1) / wsum[:, None]  # (T, 2)
    d = pix - cen[:, None, :]
    t_along = jnp.sum(d * line_dir[:, None, :], axis=-1)  # (T, t*t)
    t_cross = d[..., 0] * line_dir[:, None, 1] - d[..., 1] * line_dir[:, None, 0]

    BIG = 1e9
    t_min = jnp.min(jnp.where(support, t_along, BIG), axis=1)
    t_max = jnp.max(jnp.where(support, t_along, -BIG), axis=1)
    spread = jnp.sqrt(
        jnp.sum(wsup * t_cross * t_cross, axis=1) / wsum
    )  # weighted RMS across-line

    ok = (
        (n_sup >= cfg.min_support_frac * t * t)
        & (aniso > 0.85)
        & (spread <= cfg.max_perp_spread)
        & (t_max - t_min >= 4.0)
    )
    sp = cen + t_min[:, None] * line_dir
    ep = cen + t_max[:, None] * line_dir
    resp = jnp.sqrt(wsum / jnp.maximum(n_sup, 1))
    return sp, ep, resp, ok


def _merge_pass(sp, ep, resp, valid, cfg: LineConfig):
    """One absorb pass: every valid segment may absorb weaker mergeable
    segments that chose it as their best absorber (uselongline::MergeLines
    gates: angle, perpendicular offset, axial gap)."""
    d = ep - sp
    length = jnp.linalg.norm(d, axis=-1)
    dirs = d / jnp.maximum(length, 1e-9)[:, None]
    mid = 0.5 * (sp + ep)

    # Angle gap mod pi.
    ang = jnp.arctan2(d[:, 1], d[:, 0]) % jnp.pi
    dang = jnp.abs(ang[:, None] - ang[None, :])
    dang = jnp.minimum(dang, jnp.pi - dang)

    # Perpendicular offset of j's midpoint from i's axis.
    rel = mid[None, :, :] - mid[:, None, :]  # (i, j, 2)
    perp = jnp.abs(rel[..., 0] * dirs[:, None, 1] - rel[..., 1] * dirs[:, None, 0])

    # Axial gap: intervals of i and j projected on i's axis.
    def proj(p):  # (j,2) points onto axis of i -> (i, j)
        r = p[None, :, :] - mid[:, None, :]
        return jnp.sum(r * dirs[:, None, :], axis=-1)

    i_lo, i_hi = -0.5 * length[:, None], 0.5 * length[:, None]
    j_a, j_b = proj(sp), proj(ep)
    j_lo, j_hi = jnp.minimum(j_a, j_b), jnp.maximum(j_a, j_b)
    gap = jnp.maximum(j_lo - i_hi, i_lo - j_hi)  # negative = overlap

    mergeable = (
        (dang < cfg.merge_angle)
        & (perp < cfg.merge_perp)
        & (gap < cfg.merge_gap)
        & valid[:, None]
        & valid[None, :]
        & ~jnp.eye(sp.shape[0], dtype=bool)
    )
    # j may be absorbed by i only if i is strictly stronger (longer; index
    # breaks ties) — guarantees the absorber itself survives this pass.
    # Strictly increasing tie-break so exact duplicates (phase-0 vs phase-1
    # tiling) always have a unique absorber.
    key = length + (1e-3 / sp.shape[0]) * jnp.arange(sp.shape[0])
    stronger = key[:, None] > key[None, :]
    can_absorb = mergeable & stronger
    # Best absorber of j = the longest i with can_absorb[i, j].
    score = jnp.where(can_absorb, key[:, None], -1.0)
    absorber = jnp.argmax(score, axis=0)  # (j,)
    absorbed = jnp.max(score, axis=0) > 0.0
    absorb_mat = (
        (jnp.arange(sp.shape[0])[:, None] == absorber[None, :]) & absorbed[None, :]
    )  # (i, j): i absorbs j

    # New extent of i: extremes over its own interval and all absorbed j's.
    BIG = 1e9
    lo_j = jnp.where(absorb_mat, j_lo, BIG)
    hi_j = jnp.where(absorb_mat, j_hi, -BIG)
    new_lo = jnp.minimum(i_lo[:, 0], jnp.min(lo_j, axis=1))
    new_hi = jnp.maximum(i_hi[:, 0], jnp.max(hi_j, axis=1))
    sp_new = mid + new_lo[:, None] * dirs
    ep_new = mid + new_hi[:, None] * dirs
    resp_new = jnp.maximum(resp, jnp.max(jnp.where(absorb_mat, resp[None, :], 0.0), axis=1))
    valid_new = valid & ~absorbed
    return sp_new, ep_new, resp_new, valid_new


@partial(jax.jit, static_argnames=("cfg",))
def detect_lines(img, cfg: LineConfig = LineConfig()) -> LineFeatures:
    """img: (H, W) float32 grayscale in [0, 255] -> LineFeatures."""
    c0 = _tile_candidates(img, cfg, 0)
    c1 = _tile_candidates(img, cfg, cfg.tile // 2)
    sp, ep, resp, valid = (
        jnp.concatenate([a, b], axis=0) for a, b in zip(c0, c1)
    )

    # Pre-truncate to a fixed merge pool: most tiles propose nothing, and the
    # (T, T) merge matrices dominate compile+run cost at full tile count.
    pool = min(4 * cfg.n_lines, valid.shape[0])
    pre_len = jnp.linalg.norm(ep - sp, axis=-1)
    _, keep = jax.lax.top_k(jnp.where(valid, pre_len, -1.0), pool)
    sp, ep, resp, valid = sp[keep], ep[keep], resp[keep], valid[keep]

    def body(carry, _):
        return _merge_pass(*carry, cfg), None

    (sp, ep, resp, valid), _ = jax.lax.scan(
        body, (sp, ep, resp, valid), None, length=cfg.merge_passes
    )

    length = jnp.linalg.norm(ep - sp, axis=-1)
    valid = valid & (length >= cfg.min_len)

    # Top-K by length into the fixed capacity.
    score = jnp.where(valid, length, -1.0)
    k = min(cfg.n_lines, score.shape[0])
    top_v, top_i = jax.lax.top_k(score, k)
    sp, ep, resp = sp[top_i], ep[top_i], resp[top_i]
    length = jnp.maximum(top_v, 0.0)
    valid = top_v > 0.0
    if k < cfg.n_lines:  # pad up to capacity
        pad = cfg.n_lines - k
        sp = jnp.pad(sp, ((0, pad), (0, 0)))
        ep = jnp.pad(ep, ((0, pad), (0, 0)))
        resp = jnp.pad(resp, (0, pad))
        length = jnp.pad(length, (0, pad))
        valid = jnp.pad(valid, (0, pad))

    # Canonical orientation: flip endpoints so the mean perpendicular
    # gradient along the line is positive (dark -> bright to the left).
    # LSD lines carry the same gradient-polarity convention; this makes
    # endpoint order and descriptors stable across frames.
    h, w = img.shape
    gx, gy = image_gradients(img)
    t_s = jnp.linspace(0.1, 0.9, 8)
    samp = sp[:, None, :] + t_s[None, :, None] * (ep - sp)[:, None, :]
    sxi = jnp.clip(jnp.round(samp[..., 0]).astype(jnp.int32), 0, w - 1)
    syi = jnp.clip(jnp.round(samp[..., 1]).astype(jnp.int32), 0, h - 1)
    d0 = ep - sp
    nrm0 = jnp.stack([-d0[:, 1], d0[:, 0]], axis=-1)
    g_per = (
        gx[syi, sxi] * nrm0[:, None, 0] + gy[syi, sxi] * nrm0[:, None, 1]
    ).sum(axis=1)
    flip = g_per < 0.0
    sp, ep = (
        jnp.where(flip[:, None], ep, sp),
        jnp.where(flip[:, None], sp, ep),
    )

    d = ep - sp
    angle = jnp.arctan2(d[:, 1], d[:, 0])  # full-circle canonical angle
    # Homogeneous image-line equation, normalized like mvKeyLineFunctions /
    # mvle_l (LineExtractor.cpp:352-362): (sp,1) x (ep,1) / sqrt(a^2+b^2).
    a = sp[:, 1] - ep[:, 1]
    b = ep[:, 0] - sp[:, 0]
    c = sp[:, 0] * ep[:, 1] - sp[:, 1] * ep[:, 0]
    nrm = jnp.maximum(jnp.sqrt(a * a + b * b), 1e-9)
    eq2d = jnp.stack([a / nrm, b / nrm, c / nrm], axis=-1)
    return LineFeatures(
        sp=sp, ep=ep, angle=angle, length=length, eq2d=eq2d,
        response=resp, valid=valid,
    )
