"""3D line fitting from depth samples along 2D segments, fully batched.

Replaces Frame::isLineGood (reference src/Frame.cc:662-750) and the
per-line RANSAC of LINEextractor::extract3dline_mahdist
(add_src/LineExtractor.cpp:216-323) with fixed-shape batched programs:

- each detected 2D segment gets exactly ``N_SAMPLES`` equally spaced depth
  samples (the reference samples min(len, 20)+1 points and skips holes; we
  sample 24 and mask holes);
- per-sample 3D covariance follows compPt3dCov (LineExtractor.cpp:40-95):
  cov = J0 diag(1, 1, sigma_z^2) J0^T with J0 = [[z/f,0,x/z],[0,z/f,y/z],
  [0,0,1]] and sigma_z = 0.00273 z^2 + 0.00074 z - 0.00058 (depthStdDev,
  LineExtractor.cpp:27-38). The reference whitens via SVD of cov; we use the
  algebraically identical closed form A = diag(1,1,1/sigma_z) J0^{-1}
  (J0 is triangular), so no batched SVD is needed;
- RANSAC becomes ``N_TRIALS`` *fixed* candidate pairs evaluated in parallel
  (the reference runs <= 10 sequential trials with early exit); Mahalanobis
  point-to-line distance threshold 3.0 (LineExtractor.cpp:229);
- the reference's verify3dLine support-spread check (10 cells, >= 70%
  occupied, LineExtractor.cpp:95-160) gates each trial;
- the winner is refined by one PCA refit over its inliers (power iteration
  instead of SVD) + re-selection, mirroring the reference's refit loop with
  a fixed iteration count;
- endpoints = extremal inlier projections; a line is kept if >= MIN_PTS
  samples were valid and the endpoint gap exceeds 0.02 m (Frame.cc:736).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from pslam.geometry import Camera

N_SAMPLES = 24
N_TRIALS = 16
MIN_PTS = 5  # reference: pts3d.size() < 5 -> no line (Frame.cc:714)
MAH_THRESH = 3.0
MIN_LEN_3D = 0.02


def depth_std(z):
    """Kinect-style depth noise model (depthStdDev, LineExtractor.cpp:27)."""
    return jnp.maximum(0.00273 * z * z + 0.00074 * z - 0.00058, 1e-4)


def _whitening(cam: Camera, X):
    """Per-point whitening A (..., 3, 3) with A^T A = cov^{-1}.

    cov = J0 D J0^T  =>  A = D^{-1/2} J0^{-1};  J0^{-1} is closed-form:
    [[f/z, 0, -f x/z^2], [0, f/z, -f y/z^2], [0, 0, 1]] (uses fx for both
    axes like the reference, which passes a single focal f).
    """
    x, y, z = X[..., 0], X[..., 1], X[..., 2]
    z = jnp.maximum(z, 1e-6)
    f = cam.fx
    sz = depth_std(z)
    zero = jnp.zeros_like(z)
    A = jnp.stack(
        [
            jnp.stack([f / z, zero, -f * x / (z * z)], axis=-1),
            jnp.stack([zero, f / z, -f * y / (z * z)], axis=-1),
            jnp.stack([zero, zero, 1.0 / sz], axis=-1),
        ],
        axis=-2,
    )
    return A


def _mah_dist_point_line(Xw, Aw, Bw):
    """Whitened point-to-line distance.

    Xw: whitened points (..., 3); Aw/Bw: whitened line endpoints (..., 3).
    dist = |(Xw-Aw) x (Xw-Bw)| / |Bw-Aw| — identical to mah_dist3d_pt_line
    (LineExtractor.cpp:187-214) after whitening.
    """
    u = Xw - Aw
    v = Xw - Bw
    cr = jnp.cross(u, v)
    num = jnp.linalg.norm(cr, axis=-1)
    den = jnp.maximum(jnp.linalg.norm(Bw - Aw, axis=-1), 1e-9)
    return num / den


def _support_spread_ok(t_proj, valid, n_cells: int = 10, ratio: float = 0.7):
    """verify3dLine: project inliers on the line, split the extent into 10
    cells, require >= 70% occupied. t_proj: (..., S) projections; valid:
    (..., S) inlier mask."""
    BIG = 1e9
    t_lo = jnp.min(jnp.where(valid, t_proj, BIG), axis=-1, keepdims=True)
    t_hi = jnp.max(jnp.where(valid, t_proj, -BIG), axis=-1, keepdims=True)
    span = jnp.maximum(t_hi - t_lo, 1e-9)
    lam = jnp.clip((t_proj - t_lo) / span, 0.0, 1.0 - 1e-6)
    cell = jnp.floor(lam * n_cells).astype(jnp.int32)
    occupied = jnp.zeros(t_proj.shape[:-1] + (n_cells,), bool)
    onehot = (
        cell[..., None] == jnp.arange(n_cells)
    ) & valid[..., None]  # (..., S, n_cells)
    occupied = jnp.any(onehot, axis=-2)
    frac = jnp.mean(occupied.astype(jnp.float32), axis=-1)
    return frac > ratio


def _trial_pairs():
    """(N_TRIALS, 2) static sample-index pairs, spread across the segment."""
    rng = np.random.default_rng(7)
    pairs = []
    # Deterministic long-baseline pairs first (robust when few holes).
    for a, b in [(0, N_SAMPLES - 1), (2, N_SAMPLES - 3), (4, N_SAMPLES - 5),
                 (1, N_SAMPLES // 2), (N_SAMPLES // 2, N_SAMPLES - 2)]:
        pairs.append((a, b))
    while len(pairs) < N_TRIALS:
        a, b = rng.choice(N_SAMPLES, 2, replace=False)
        if abs(a - b) >= N_SAMPLES // 4:
            pairs.append((int(min(a, b)), int(max(a, b))))
    return np.asarray(pairs[:N_TRIALS], np.int32)


_PAIRS = _trial_pairs()


def _principal_dir(X, w, iters: int = 8):
    """Weighted principal direction of points (..., S, 3), weights (..., S).
    Power iteration on the 3x3 scatter matrix (replaces computeLine3d_svd's
    cv::SVD, LineExtractor.cpp:163-185)."""
    wsum = jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1e-9)
    mean = jnp.sum(X * w[..., None], axis=-2) / wsum
    d = (X - mean[..., None, :]) * jnp.sqrt(w)[..., None]
    C = jnp.einsum("...si,...sj->...ij", d, d)
    v = jnp.ones(X.shape[:-2] + (3,), X.dtype) * jnp.asarray([0.6, 0.5, 0.63])
    for _ in range(iters):
        v = jnp.einsum("...ij,...j->...i", C, v)
        v = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-12)
    return mean, v


@partial(jax.jit, static_argnames=("cam",))
def fit_lines_3d(cam: Camera, depth_img, sp, ep, line_valid):
    """Fit a 3D segment to each 2D segment from depth.

    depth_img: (H, W) float32 meters (0/neg = hole);
    sp/ep: (NL, 2) segment endpoints; line_valid: (NL,) bool.

    Returns (p3_s (NL,3), p3_e (NL,3), dir3d (NL,3), ok (NL,)) in the camera
    frame; dir3d is the normalized direction (reference mvLineEq semantics,
    Frame.cc:739-746).
    """
    h, w = depth_img.shape
    lam = jnp.linspace(0.0, 1.0, N_SAMPLES)[None, :, None]  # (1, S, 1)
    pts = sp[:, None, :] * (1.0 - lam) + ep[:, None, :] * lam  # (NL, S, 2)
    xi = jnp.clip(jnp.round(pts[..., 0]).astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(jnp.round(pts[..., 1]).astype(jnp.int32), 0, h - 1)
    z = depth_img[yi, xi]  # (NL, S)
    valid = (z > 0.01) & line_valid[:, None]

    x = (xi.astype(jnp.float32) - cam.cx) * z / cam.fx
    y = (yi.astype(jnp.float32) - cam.cy) * z / cam.fy
    X = jnp.stack([x, y, jnp.where(valid, z, 1.0)], axis=-1)  # (NL, S, 3)
    A = _whitening(cam, X)  # (NL, S, 3, 3)
    Xw = jnp.einsum("nsij,nsj->nsi", A, X)  # whitened points

    # --- fixed-trial RANSAC -------------------------------------------
    ia, ib = _PAIRS[:, 0], _PAIRS[:, 1]
    Pa = X[:, ia]  # (NL, T, 3) candidate endpoints (raw space)
    Pb = X[:, ib]
    pair_ok = valid[:, ia] & valid[:, ib] & (
        jnp.linalg.norm(Pb - Pa, axis=-1) > 1e-8
    )

    # Whitened endpoints per (point, trial): each sample point has its own
    # whitening, so A_s is applied to the *candidate* endpoints too.
    Aw_a = jnp.einsum("nsij,ntj->nsti", A, Pa)  # (NL, S, T, 3)
    Aw_b = jnp.einsum("nsij,ntj->nsti", A, Pb)
    dist = _mah_dist_point_line(Xw[:, :, None, :], Aw_a, Aw_b)  # (NL, S, T)
    inl = (dist < MAH_THRESH) & valid[:, :, None] & pair_ok[:, None, :]

    # Support-spread gate per trial.
    dir_t = Pb - Pa  # (NL, T, 3)
    t_proj = jnp.einsum("nsi,nti->nst", X, dir_t)
    spread_ok = _support_spread_ok(
        jnp.swapaxes(t_proj, 1, 2), jnp.swapaxes(inl, 1, 2)
    )  # (NL, T)

    n_inl = jnp.sum(inl, axis=1) * spread_ok * pair_ok  # (NL, T)
    best_t = jnp.argmax(n_inl, axis=-1)  # (NL,)
    best_n = jnp.take_along_axis(n_inl, best_t[:, None], axis=-1)[:, 0]
    best_inl = jnp.take_along_axis(
        inl, best_t[:, None, None], axis=2
    )[:, :, 0]  # (NL, S)

    # --- PCA refit over the winning inlier set + one re-selection -------
    wgt = best_inl.astype(jnp.float32)
    mean, vdir = _principal_dir(X, wgt)
    Am = jnp.einsum("nsij,nj->nsi", A, mean)
    Ad = jnp.einsum("nsij,nj->nsi", A, mean + vdir)
    dist2 = _mah_dist_point_line(Xw, Am, Ad)
    inl2 = (dist2 < MAH_THRESH) & valid
    grew = jnp.sum(inl2, axis=-1) > best_n
    final_inl = jnp.where(grew[:, None], inl2, best_inl)
    wgt = final_inl.astype(jnp.float32)
    mean, vdir = _principal_dir(X, wgt)

    # --- endpoints: extremal projections of inliers ---------------------
    t_all = jnp.einsum("nsi,ni->ns", X - mean[:, None, :], vdir)
    BIG = 1e9
    t_lo = jnp.min(jnp.where(final_inl, t_all, BIG), axis=-1)
    t_hi = jnp.max(jnp.where(final_inl, t_all, -BIG), axis=-1)
    p3_s = mean + t_lo[:, None] * vdir
    p3_e = mean + t_hi[:, None] * vdir

    n_valid = jnp.sum(valid, axis=-1)
    n_final = jnp.sum(final_inl, axis=-1)
    seg = p3_e - p3_s
    seg_len = jnp.linalg.norm(seg, axis=-1)
    ok = (
        line_valid
        & (n_valid >= MIN_PTS)
        & (n_final >= 2)
        & (seg_len > MIN_LEN_3D)
    )
    dir3d = seg / jnp.maximum(seg_len, 1e-9)[:, None]
    zero = jnp.zeros_like(p3_s)
    return (
        jnp.where(ok[:, None], p3_s, zero),
        jnp.where(ok[:, None], p3_e, zero),
        jnp.where(ok[:, None], dir3d, zero),
        ok,
    )
