"""Epipolar matching + two-view triangulation of new map points.

Data-parallel replacement for LocalMapping::CreateNewMapPoints
(reference src/LocalMapping.cc:275-520) and
ORBmatcher::SearchForTriangulation (src/ORBmatcher.cc:657): instead of
per-feature BoW-bucket loops with an epipolar check, the whole KF-pair
match is one masked Hamming distance matrix with an epipolar-band mask,
and triangulation + the chi^2 / scale-consistency gates run batched over
all matched pairs in the same jit dispatch.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from pslam.geometry import Camera
from pslam.ops.match import (
    TH_LOW,
    hamming_matrix,
    mutual_nn_match,
    rotation_consistency_mask,
)


class KFView(NamedTuple):
    """One keyframe's features as seen by the triangulator (device arrays)."""

    T_cw: jnp.ndarray  # (4, 4)
    uv: jnp.ndarray  # (N, 2)
    ur: jnp.ndarray  # (N,) virtual right u, -1 = no depth
    depth: jnp.ndarray  # (N,) RGB-D depth, 0 = hole
    level: jnp.ndarray  # (N,) int32
    angle: jnp.ndarray  # (N,)
    desc: jnp.ndarray  # (N, 32) uint8
    free: jnp.ndarray  # (N,) bool: valid AND not yet bound to a map point


def _cam_center(T_cw):
    return -T_cw[:3, :3].T @ T_cw[:3, 3]


def _fundamental(cam: Camera, T1, T2):
    """F12 such that x2^T F12^T ... reference ComputeF12
    (LocalMapping.cc:893-915): F = K1^-T [t12]x R12 K2^-1 with
    T12 = T1 T2^-1 mapping cam2 -> cam1. We return F mapping a point in
    image1 to its epipolar LINE in image2: l2 = F21 x1."""
    T21 = T2 @ jnp.linalg.inv(T1)  # cam1 -> cam2
    R = T21[:3, :3]
    t = T21[:3, 3]
    tx = jnp.array(
        [[0.0, -t[2], t[1]], [t[2], 0.0, -t[0]], [-t[1], t[0], 0.0]],
        jnp.float32,
    )
    K = cam.K
    Kinv = jnp.linalg.inv(K)
    return Kinv.T @ (tx @ R) @ Kinv  # l2 = F @ x1


def _rays_world(cam: Camera, T_cw, uv):
    """Unit-norm world-frame view rays through pixels uv."""
    x = (uv[:, 0] - cam.cx) / cam.fx
    y = (uv[:, 1] - cam.cy) / cam.fy
    d_c = jnp.stack([x, y, jnp.ones_like(x)], axis=-1)
    d_w = d_c @ T_cw[:3, :3]  # R^T d
    return d_w / jnp.linalg.norm(d_w, axis=-1, keepdims=True)


def _unproject_view(cam: Camera, T_cw, uv, depth):
    """Backproject pixels with depth to world frame."""
    x = (uv[:, 0] - cam.cx) / cam.fx * depth
    y = (uv[:, 1] - cam.cy) / cam.fy * depth
    Xc = jnp.stack([x, y, depth], axis=-1)
    return (Xc - T_cw[:3, 3]) @ T_cw[:3, :3]


def _reproj_ok(cam: Camera, T_cw, X_w, uv, ur, level, sigma2, chi_mono, chi_stereo):
    """Positive depth + chi^2 reprojection gate in one view
    (LocalMapping.cc:424-470)."""
    Xc = (X_w @ T_cw[:3, :3].T) + T_cw[:3, 3]
    z = Xc[:, 2]
    z_safe = jnp.maximum(z, 1e-9)
    u = cam.fx * Xc[:, 0] / z_safe + cam.cx
    v = cam.fy * Xc[:, 1] / z_safe + cam.cy
    urr = u - cam.bf / z_safe
    s2 = sigma2[jnp.clip(level, 0, sigma2.shape[0] - 1)]
    e2 = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
    mono_ok = e2 < chi_mono * s2
    stereo_ok = (e2 + (urr - ur) ** 2) < chi_stereo * s2
    ok = jnp.where(ur >= 0, stereo_ok, mono_ok)
    return (z > 0) & ok, z


@partial(jax.jit, static_argnames=("cam", "scale", "levels"))
def epipolar_triangulate(
    cam: Camera, kf1: KFView, kf2: KFView, scale: float = 1.2, levels: int = 8
):
    """Match free features of kf1 against kf2 along the epipolar band and
    triangulate (or unproject from either view's depth when parallax is too
    low — the RGB-D branch of LocalMapping.cc:391-422).

    Returns per-feature-of-kf1: (idx2 (N,) int32 match or -1,
    X_w (N, 3) new world point, ok (N,) bool all gates passed).
    """
    sigma2 = jnp.asarray([(scale**l) ** 2 for l in range(levels)], jnp.float32)

    dist = hamming_matrix(kf1.desc, kf2.desc)

    # Epipolar band: distance of kf2 feature to the epipolar line of the kf1
    # feature < 3.84 sigma2(level2) (CheckDistEpipolarLine, ORBmatcher.cc:612).
    F = _fundamental(cam, kf1.T_cw, kf2.T_cw)
    x1 = jnp.concatenate([kf1.uv, jnp.ones_like(kf1.uv[:, :1])], axis=1)
    l2 = x1 @ F.T  # (N1, 3)
    num = l2[:, None, 0] * kf2.uv[None, :, 0] + l2[:, None, 1] * kf2.uv[None, :, 1] + l2[:, None, 2]
    den = l2[:, 0] ** 2 + l2[:, 1] ** 2
    d2 = num**2 / jnp.maximum(den[:, None], 1e-12)
    s2_2 = sigma2[jnp.clip(kf2.level, 0, levels - 1)]
    epi_ok = d2 < 3.84 * s2_2[None, :]

    # Keep kf2 features away from the epipole (ORBmatcher.cc:700-707).
    C1_in_2 = (
        _cam_center(kf1.T_cw) @ kf2.T_cw[:3, :3].T + kf2.T_cw[:3, 3]
    )
    ex = cam.fx * C1_in_2[0] / jnp.maximum(C1_in_2[2], 1e-9) + cam.cx
    ey = cam.fy * C1_in_2[1] / jnp.maximum(C1_in_2[2], 1e-9) + cam.cy
    de2 = (kf2.uv[:, 0] - ex) ** 2 + (kf2.uv[:, 1] - ey) ** 2
    sfac2 = jnp.asarray([scale**l for l in range(levels)], jnp.float32)
    far_from_epipole = de2 > 100.0 * sfac2[jnp.clip(kf2.level, 0, levels - 1)]
    epi_ok = epi_ok & (far_from_epipole | (kf2.ur >= 0))[None, :]

    idx2, _ = mutual_nn_match(
        dist,
        valid_a=kf1.free,
        valid_b=kf2.free,
        max_dist=TH_LOW,
        ratio=1.0,
        extra_mask=epi_ok,
    )
    j0 = jnp.maximum(idx2, 0)
    # All per-match row gathers from kf2 as ONE one-hot matmul (ROADMAP
    # design item 1 weighs it against a plain gather).
    N2 = kf2.uv.shape[0]
    r2_all = _rays_world(cam, kf2.T_cw, kf2.uv)
    X_d2_all = _unproject_view(cam, kf2.T_cw, kf2.uv, kf2.depth)
    vals2 = jnp.concatenate(
        [
            kf2.angle[:, None],
            kf2.depth[:, None],
            kf2.uv,
            kf2.ur[:, None],
            kf2.level.astype(jnp.float32)[:, None],
            r2_all,
            X_d2_all,
        ],
        axis=1,
    )  # (N2, 12)
    sel = (j0[:, None] == jnp.arange(N2)[None, :]).astype(jnp.float32)
    g = jax.lax.dot_general(
        sel, vals2, (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )  # (N1, 12)
    g_angle, g_depth = g[:, 0], g[:, 1]
    g_uv, g_ur = g[:, 2:4], g[:, 4]
    g_level = jnp.round(g[:, 5]).astype(jnp.int32)
    r2, X_d2 = g[:, 6:9], g[:, 9:12]

    keep = rotation_consistency_mask(kf1.angle, g_angle, idx2 >= 0)
    idx2 = jnp.where(keep, idx2, -1)

    # --- triangulation (LocalMapping.cc:352-422) ---------------------------
    C1 = _cam_center(kf1.T_cw)
    C2 = _cam_center(kf2.T_cw)
    r1 = _rays_world(cam, kf1.T_cw, kf1.uv)
    cos_par = jnp.sum(r1 * r2, axis=-1)

    # Stereo parallax from depth: cos(2 atan2(b/2, z)) (LocalMapping.cc:372).
    b = cam.baseline
    cp_s1 = jnp.where(
        kf1.depth > 0, jnp.cos(2.0 * jnp.arctan2(b / 2.0, jnp.maximum(kf1.depth, 1e-9))), 2.0
    )
    cp_s2 = jnp.where(
        g_depth > 0, jnp.cos(2.0 * jnp.arctan2(b / 2.0, jnp.maximum(g_depth, 1e-9))), 2.0
    )
    cp_stereo = jnp.minimum(cp_s1, cp_s2)

    # Two-ray midpoint least squares: min ||C1 + a r1 - C2 - b r2||.
    w = C2 - C1
    rr = cos_par
    a_num = jnp.sum(w * r1, axis=-1) - rr * jnp.sum(w * r2, axis=-1)
    b_num = rr * jnp.sum(w * r1, axis=-1) - jnp.sum(w * r2, axis=-1)
    det = jnp.maximum(1.0 - rr * rr, 1e-9)
    aa = a_num / det
    bb = b_num / det
    X_tri = 0.5 * (C1 + aa[:, None] * r1 + C2 + bb[:, None] * r2)

    # Unprojections from depth (X_d2 gathered above).
    X_d1 = _unproject_view(cam, kf1.T_cw, kf1.uv, kf1.depth)

    good_par = (cos_par > 0) & (cos_par < 0.9998) & (cos_par < cp_stereo)
    use_d1 = (~good_par) & (kf1.depth > 0)
    use_d2 = (~good_par) & (~use_d1) & (g_depth > 0)
    X_w = jnp.where(
        good_par[:, None],
        X_tri,
        jnp.where(use_d1[:, None], X_d1, X_d2),
    )
    has_X = good_par | use_d1 | use_d2

    # --- acceptance gates ---------------------------------------------------
    ok1, z1 = _reproj_ok(
        cam, kf1.T_cw, X_w, kf1.uv, kf1.ur, kf1.level, sigma2, 5.991, 7.8
    )
    ok2, z2 = _reproj_ok(
        cam, kf2.T_cw, X_w, g_uv, g_ur, g_level, sigma2, 5.991, 7.8
    )

    # Scale consistency (LocalMapping.cc:488-501).
    d1 = jnp.linalg.norm(X_w - C1, axis=-1)
    d2 = jnp.linalg.norm(X_w - C2, axis=-1)
    ratio_dist = d2 / jnp.maximum(d1, 1e-9)
    ratio_oct = sfac2[jnp.clip(kf1.level, 0, levels - 1)] / sfac2[
        jnp.clip(g_level, 0, levels - 1)
    ]
    ratio_factor = 1.5 * scale
    scale_ok = (ratio_dist * ratio_factor > ratio_oct) & (
        ratio_dist < ratio_oct * ratio_factor
    )

    ok = (idx2 >= 0) & has_X & ok1 & ok2 & scale_ok & (d1 > 1e-6) & (d2 > 1e-6)
    return jnp.where(ok, idx2, -1), X_w, ok


@partial(jax.jit, static_argnames=("cam", "scale", "levels"))
def epipolar_triangulate_batch(
    cam: Camera, kf1: KFView, kf2s: KFView, scale: float = 1.2,
    levels: int = 8,
):
    """Triangulate kf1 against a STACK of neighbour views in one dispatch
    (kf2s leaves carry a leading neighbour axis). The reference loops its
    ~10 covisible neighbours sequentially (LocalMapping.cc:275-520); here
    the loop becomes a vmap so keyframe insertion costs one launch
    instead of ten round trips."""
    return jax.vmap(
        lambda v2: epipolar_triangulate(cam, kf1, v2, scale, levels)
    )(kf2s)
