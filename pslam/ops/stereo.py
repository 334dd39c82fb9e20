"""Stereo matching: row-banded descriptor search + sub-pixel SAD refine.

Data-parallel replacement for Frame::ComputeStereoMatches (reference
src/Frame.cc:1165-1340, the third sensor pipeline, Tracking::GrabImageStereo
Tracking.cc:174): instead of per-row candidate lists and a serial SAD slide
per keypoint, the whole frame is

1. one masked (NL, NR) Hamming matrix between left/right keypoints with a
   row band |vL - vR| <= 2 sigma(octave) and the disparity bounds
   [minD, maxD] = [0, fx] (Frame.cc:1174-1186: maxD = bf / baseline);
2. one batched sub-pixel refinement: an 11x11 left patch is correlated
   against an 11x(11+2*L) right strip (L = 5 slide, Frame.cc:1233-1272) as
   a single einsum over the 2L+1 shifts, best-shift parabola fit
   (Frame.cc:1278-1284);
3. depth = bf / disparity for accepted matches (Frame.cc:1300-1305), with
   the reference's median-SAD outlier sweep replaced by a fixed 1.5x
   median-of-best-SADs gate (same intent, vectorized).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from pslam.geometry import Camera
from pslam.ops.match import TH_HIGH, hamming_matrix

SAD_W = 5  # half window (11x11 patch, Frame.cc:1233 w=5)
SAD_L = 5  # slide range (Frame.cc:1255)


def _gather_patch_rows(img, y0, x0, h: int, w: int):
    """(N, h, w) patches at integer top-left corners via row gather + one-hot
    column select (the extract_patches trick, ops/orb.py)."""
    H, W = img.shape
    y0 = jnp.clip(y0, 0, H - h)
    x0 = jnp.clip(x0, 0, W - w)
    rows = img[y0[:, None] + jnp.arange(h)[None, :]]  # (N, h, W)
    col = x0[:, None, None] + jnp.arange(w)[None, None, :]
    onehot = (jnp.arange(W)[None, :, None] == col).astype(img.dtype)
    return jnp.einsum(
        "nrw,nwj->nrj", rows, onehot,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )


@partial(jax.jit, static_argnames=("cam", "scale", "levels"))
def compute_stereo_matches(
    cam: Camera,
    imgL,
    imgR,
    uvL, levelL, descL, validL,
    uvR, levelR, descR, validR,
    scale: float = 1.2,
    levels: int = 8,
):
    """Per-left-keypoint virtual right coordinate + depth.

    Returns (ur (N,), depth (N,)) with ur = -1 / depth = 0 where no stereo
    match was accepted — the exact FrameData convention the RGB-D path
    produces from the depth map, so everything downstream is shared.
    """
    sfac = jnp.asarray([scale**l for l in range(levels)], jnp.float32)
    sigL = sfac[jnp.clip(levelL, 0, levels - 1)]

    # --- 1. coarse match: Hamming + row band + disparity bounds ----------
    dist = hamming_matrix(descL, descR)
    dv = jnp.abs(uvL[:, None, 1] - uvR[None, :, 1])
    band = dv <= 2.0 * sigL[:, None]  # Frame.cc:1198: r = 2 f * sigma
    disp = uvL[:, None, 0] - uvR[None, :, 0]
    min_d, max_d = 0.0, cam.fx  # maxD = bf/b = fx (Frame.cc:1184)
    dbound = (disp > min_d) & (disp <= max_d)
    lvl_ok = (
        jnp.abs(levelL[:, None] - levelR[None, :]) <= 1
    )  # Frame.cc:1216: candidate octave within [octave-1, octave+1]
    ok = band & dbound & lvl_ok & validL[:, None] & validR[None, :]
    d = jnp.where(ok, dist, 1 << 20)
    jR = jnp.argmin(d, axis=1)
    best = jnp.min(d, axis=1)
    coarse = best <= TH_HIGH  # thOrbDist analogue (Frame.cc:1224)

    # --- 2. sub-pixel SAD refine around the matched right column ---------
    # (level-0 images; the reference slides on the octave image with scaled
    # coords — same geometry, our detector reports level-0 coords).
    w, L = SAD_W, SAD_L
    yL = jnp.round(uvL[:, 1]).astype(jnp.int32)
    xL = jnp.round(uvL[:, 0]).astype(jnp.int32)
    uR0 = uvR[jR, 0]
    xR = jnp.round(uR0).astype(jnp.int32)
    patchL = _gather_patch_rows(imgL, yL - w, xL - w, 2 * w + 1, 2 * w + 1)
    strip = _gather_patch_rows(
        imgR, yL - w, xR - w - L, 2 * w + 1, 2 * w + 1 + 2 * L
    )
    # Center-pixel normalization (Frame.cc:1238-1249): IL minus ITS center,
    # and every candidate right window minus ITS OWN center (per shift —
    # a single strip-wide center biases the SAD by the local gradient and
    # costs ~0.4 px of disparity accuracy).
    patchL = patchL - patchL[:, w, w][:, None, None]
    # All 2L+1 shifts in one shot: windows[n, s] = strip[:, :, s:s+11].
    idx = jnp.arange(2 * w + 1)[None, :] + jnp.arange(2 * L + 1)[:, None]
    wins = strip[:, :, idx]  # (N, 11, 2L+1, 11)
    wins = wins - wins[:, w, :, w][:, None, :, None]
    sads = jnp.sum(
        jnp.abs(wins - patchL[:, :, None, :]), axis=(1, 3)
    )  # (N, 2L+1)
    s_best = jnp.argmin(sads, axis=1)
    sad_min = jnp.min(sads, axis=1)
    interior = (s_best > 0) & (s_best < 2 * L)  # Frame.cc:1275
    sm1 = sads[jnp.arange(sads.shape[0]), jnp.maximum(s_best - 1, 0)]
    sp1 = sads[jnp.arange(sads.shape[0]), jnp.minimum(s_best + 1, 2 * L)]
    denom = jnp.maximum(2.0 * (sm1 + sp1 - 2.0 * sad_min), 1e-6)
    delta = (sm1 - sp1) / denom  # parabola vertex (Frame.cc:1282)
    delta = jnp.clip(delta, -1.0, 1.0)
    uR = xR.astype(jnp.float32) + (
        s_best.astype(jnp.float32) - L
    ) + delta

    # Disparity between PATCH CENTERS: the SAD was measured around the
    # ROUNDED left x, so the physical disparity is xL - uR; mixing in the
    # fractional uvL (scaled up from higher octaves) adds up to 0.5 px of
    # rounding error. The reported ur keeps the uvL frame:
    # ur = uvL_x - disparity.
    disp_f = xL.astype(jnp.float32) - uR
    uR = uvL[:, 0] - disp_f
    good = (
        coarse & interior & (jnp.abs(delta) <= 1.0)
        & (disp_f > min_d) & (disp_f <= max_d)
    )
    # Median-SAD outlier sweep (Frame.cc:1308-1330: drop > 1.5 * 1.4 median).
    sad_sorted = jnp.sort(jnp.where(good, sad_min, jnp.inf))
    n_good = jnp.sum(good.astype(jnp.int32))
    med = sad_sorted[jnp.maximum(n_good // 2, 0)]
    good = good & (sad_min <= 2.1 * med + 1e-3)

    disp_safe = jnp.maximum(disp_f, 1e-6)
    depth = jnp.where(good, cam.bf / disp_safe, 0.0)
    ur = jnp.where(good, uR, -1.0)
    return ur, depth
