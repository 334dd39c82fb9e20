"""Fused device programs for per-frame tracking.

Each function is one jit dispatch (the whole match->optimize chain is
fused):

- ``track_against_points``: the core of TrackWithMotionModel /
  TrackReferenceKeyFrame (reference Tracking.cc:1164, 880): project candidate
  map points with a pose prior, window-masked Hamming matching, rotation
  consistency, then PoseOptimization.
- ``track_local_map_step``: SearchLocalPoints + second PoseOptimization
  (Tracking.cc:1317-1408), also returning per-point visible/found flags for
  the host's MapPoint statistics.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from pslam.geometry import Camera, in_image, project_stereo, se3_inverse, transform_points
from pslam.ops.match import (
    TH_HIGH,
    TH_LOW,
    hamming_matrix,
    level_window_mask,
    mutual_nn_match,
    rotation_consistency_mask,
    window_mask,
)
from pslam.ops.orb import scale_sigma2
from pslam.pipeline.frame_ops import FrameData
from pslam.solver.lil import LILPoseObs
from pslam.solver.pose_opt import PoseObs, pose_optimization


class PointSet(NamedTuple):
    """A fixed-capacity set of candidate map points (device snapshot)."""

    pos: jnp.ndarray  # (M, 3) world positions
    desc: jnp.ndarray  # (M, 32) uint8
    level: jnp.ndarray  # (M,) reference observation octave
    angle: jnp.ndarray  # (M,)
    min_dist: jnp.ndarray  # (M,) scale-invariance band
    max_dist: jnp.ndarray  # (M,)
    normal: jnp.ndarray  # (M, 3) mean viewing direction
    valid: jnp.ndarray  # (M,) bool


class TrackResult(NamedTuple):
    T_cw: jnp.ndarray  # (4, 4) optimized pose
    match_point: jnp.ndarray  # (M,) feature index matched per point, -1 none
    n_matches: jnp.ndarray  # () int32 matches fed to the optimizer
    n_inliers: jnp.ndarray  # () int32 optimizer point inliers (the final
    # accept gate uses points only, Tracking.cc:1400-1406)
    inlier: jnp.ndarray  # (M,) bool per-point inlier flag
    visible: jnp.ndarray  # (M,) bool point projected into the frame
    lil_inlier: jnp.ndarray  # (Nl,) bool LIL inliers (all-False w/o LILs)
    n_weighted: jnp.ndarray  # () int32 points + 5 x LIL inliers (the
    # mid-pipeline match gates, Tracking.cc:1037, 1281-1284, 1396)


def _project_points(cam: Camera, T_cw, pts: PointSet):
    Xc = transform_points(T_cw, pts.pos)
    uvr = project_stereo(cam, Xc)
    z = Xc[..., 2]
    visible = pts.valid & (z > 0.05) & in_image(cam, uvr[..., :2], margin=1.0)
    return uvr, z, visible


def _scale_visibility(cam: Camera, T_cw, pts: PointSet, scale: float, levels: int):
    """Distance band + viewing angle checks + predicted octave
    (Frame::isInFrustum, Frame.cc; MapPoint::PredictScale)."""
    C = -jnp.einsum("ij,i->j", T_cw[:3, :3], T_cw[:3, 3])
    d = pts.pos - C[None, :]
    dist = jnp.linalg.norm(d, axis=-1)
    in_band = (dist >= pts.min_dist * 0.8) & (dist <= pts.max_dist * 1.2)
    viewcos = jnp.sum(d * pts.normal, axis=-1) / jnp.maximum(dist, 1e-9)
    ok_view = viewcos > 0.5  # cos(60 deg), Tracking.cc SearchLocalPoints
    ratio = jnp.maximum(pts.max_dist, 1e-9) / jnp.maximum(dist, 1e-9)
    pred_level = jnp.clip(
        jnp.ceil(jnp.log(ratio) / jnp.log(scale)).astype(jnp.int32), 0, levels - 1
    )
    return in_band & ok_view, pred_level


def _match_points_to_frame(
    cam: Camera,
    T_pred,
    pts: PointSet,
    frame: FrameData,
    radius: float,
    orb_scale: float,
    orb_levels: int,
    check_scale: bool,
    max_dist: int = TH_HIGH,
    ratio: float = 0.9,
):
    """Project points, window-masked Hamming match. Returns (match feature
    index per point (M,), visible mask (M,))."""
    uvr, z, visible = _project_points(cam, T_pred, pts)
    if check_scale:
        band_ok, pred_level = _scale_visibility(cam, T_pred, pts, orb_scale, orb_levels)
        visible = visible & band_ok
    else:
        pred_level = pts.level
    sig = jnp.asarray([orb_scale**l for l in range(orb_levels)], jnp.float32)
    r = radius * sig[jnp.clip(pred_level, 0, orb_levels - 1)]
    box = window_mask(uvr[:, :2], frame.uv, r)
    lvl_ok = level_window_mask(pred_level, frame.level, -1, 1)
    dist = hamming_matrix(pts.desc, frame.desc)
    idx, d = mutual_nn_match(
        dist,
        valid_a=visible,
        valid_b=frame.valid,
        max_dist=max_dist,
        ratio=ratio,
        extra_mask=box & lvl_ok,
    )
    # Rotation consistency over accepted pairs.
    pair_ok = idx >= 0
    f_angle = _gather_rows(frame.angle[:, None], idx)[:, 0]
    keep = rotation_consistency_mask(pts.angle, f_angle, pair_ok)
    return jnp.where(keep, idx, -1), visible


def _gather_rows(vals, idx):
    """vals (N, K) gathered at clamp(idx, 0) via a one-hot matmul (exact;
    ROADMAP design item 1 weighs it against a plain gather)."""
    fi = jnp.maximum(idx, 0)
    sel = (fi[:, None] == jnp.arange(vals.shape[0])[None, :]).astype(
        jnp.float32
    )
    return jax.lax.dot_general(
        sel, vals.astype(jnp.float32), (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )


def _pose_obs_from_matches(pts: PointSet, frame: FrameData, match_idx, sigma2):
    """Build the fixed-capacity PoseObs (one slot per candidate point)."""
    m = match_idx >= 0
    g = _gather_rows(
        jnp.stack(
            [frame.uv[:, 0], frame.uv[:, 1], frame.ur,
             frame.level.astype(jnp.float32)], axis=-1
        ),
        match_idx,
    )
    obs = g[:, :3]
    lvl = jnp.round(g[:, 3]).astype(jnp.int32)
    inv_s2 = 1.0 / sigma2[jnp.clip(lvl, 0, sigma2.shape[0] - 1)]
    return PoseObs(
        X_w=pts.pos,
        obs=obs,
        inv_sigma2=inv_s2,
        valid=m,
    )


def _result(T_opt, match_idx, po, inlier, visible, lil, lil_inlier):
    if lil is None:
        lil_in = jnp.zeros(1, bool)
    else:
        lil_in = lil_inlier & lil.valid
    n_pts = jnp.sum(inlier.astype(jnp.int32))
    return TrackResult(
        T_cw=T_opt,
        match_point=match_idx,
        n_matches=jnp.sum(po.valid.astype(jnp.int32)),
        n_inliers=n_pts,
        inlier=inlier,
        visible=visible,
        lil_inlier=lil_in,
        n_weighted=n_pts + 5 * jnp.sum(lil_in.astype(jnp.int32)),
    )


@partial(jax.jit, static_argnames=("cam", "orb_scale", "orb_levels", "check_scale"))
def track_against_points(
    cam: Camera,
    T_pred,
    pts: PointSet,
    frame: FrameData,
    radius,
    orb_scale: float = 1.2,
    orb_levels: int = 8,
    check_scale: bool = False,
    lil: LILPoseObs | None = None,
) -> TrackResult:
    """Motion-model / reference-KF tracking step (one dispatch).

    ``lil``: optional map-associated structural-line observations joining
    the pose cost with fixed landmarks (Optimizer.cc:619-694).
    """
    match_idx, visible = _match_points_to_frame(
        cam, T_pred, pts, frame, radius, orb_scale, orb_levels, check_scale
    )
    sigma2 = scale_sigma2_arr(orb_scale, orb_levels)
    po = _pose_obs_from_matches(pts, frame, match_idx, sigma2)
    T_opt, inlier, chi2, lil_inlier = pose_optimization(cam, T_pred, po, lil=lil)
    return _result(T_opt, match_idx, po, inlier, visible, lil, lil_inlier)


def scale_sigma2_arr(scale: float, levels: int):
    return jnp.asarray([(scale**l) ** 2 for l in range(levels)], jnp.float32)


@partial(jax.jit, static_argnames=("cam", "orb_scale", "orb_levels"))
def track_against_points_unwindowed(
    cam: Camera,
    T_prior,
    pts: PointSet,
    frame: FrameData,
    orb_scale: float = 1.2,
    orb_levels: int = 8,
) -> TrackResult:
    """Reference-KF fallback (TrackReferenceKeyFrame, Tracking.cc:880):
    descriptor-only matching with NO projection window, so arbitrary
    inter-frame motion is recoverable. The reference restricts the search to
    shared BoW nodes (ORBmatcher::SearchByBoW, ORBmatcher.cc:159) purely to
    make the CPU search tractable; on the device the full masked Hamming
    matrix is cheaper than building the buckets, so the window is simply dropped.
    Ratio 0.7 and rotation consistency match the reference's
    ``ORBmatcher matcher(0.7, true)`` (Tracking.cc:889)."""
    dist = hamming_matrix(pts.desc, frame.desc)
    idx, _ = mutual_nn_match(
        dist, valid_a=pts.valid, valid_b=frame.valid,
        max_dist=TH_LOW, ratio=0.7,
    )
    f_angle = _gather_rows(frame.angle[:, None], idx)[:, 0]
    keep = rotation_consistency_mask(pts.angle, f_angle, idx >= 0)
    match_idx = jnp.where(keep, idx, -1)
    sigma2 = scale_sigma2_arr(orb_scale, orb_levels)
    po = _pose_obs_from_matches(pts, frame, match_idx, sigma2)
    T_opt, inlier, chi2, _ = pose_optimization(cam, T_prior, po)
    return _result(T_opt, match_idx, po, inlier, pts.valid, None, None)


def _vo_point_set(prev_fd: FrameData, T_prev) -> PointSet:
    """The previous frame's depth-backed features as temporary landmarks
    (the reference's UpdateLastFrame temporal VO points,
    Tracking.cc:1110-1162) — no map involvement, nothing is ever
    inserted."""
    R = T_prev[:3, :3]
    t = T_prev[:3, 3]
    pos_w = (prev_fd.xyz_c - t) @ R  # R^T (Xc - t)
    C = -R.T @ t
    d = pos_w - C[None, :]
    dist = jnp.linalg.norm(d, axis=-1)
    return PointSet(
        pos=pos_w,
        desc=prev_fd.desc,
        level=prev_fd.level,
        angle=prev_fd.angle,
        min_dist=jnp.zeros_like(dist),
        max_dist=dist * 10.0 + 1.0,
        normal=d / jnp.maximum(dist[:, None], 1e-9),
        valid=prev_fd.valid & (prev_fd.depth > 0),
    )


@partial(jax.jit, static_argnames=("cam", "orb_scale", "orb_levels"))
def track_frame_to_frame(
    cam: Camera,
    T_prior,
    prev_fd: FrameData,
    T_prev,
    frame: FrameData,
    radius,
    orb_scale: float = 1.2,
    orb_levels: int = 8,
) -> TrackResult:
    """Windowed visual-odometry step for localization-only mbVO mode.
    Returns the same TrackResult as map tracking."""
    pts = _vo_point_set(prev_fd, T_prev)
    return track_against_points(
        cam, T_prior, pts, frame, radius, orb_scale, orb_levels,
        check_scale=False,
    )


@partial(jax.jit, static_argnames=("cam", "orb_scale", "orb_levels"))
def track_frame_to_frame_unwindowed(
    cam: Camera,
    T_prior,
    prev_fd: FrameData,
    T_prev,
    frame: FrameData,
    orb_scale: float = 1.2,
    orb_levels: int = 8,
) -> TrackResult:
    """Unwindowed VO fallback: pure descriptor matching against the
    previous frame's features, recovering fast pans whose image shift
    exceeds any projection window (the VO analogue of the ref-KF
    SearchByBoW fallback)."""
    pts = _vo_point_set(prev_fd, T_prev)
    return track_against_points_unwindowed(
        cam, T_prior, pts, frame, orb_scale, orb_levels
    )


@partial(jax.jit, static_argnames=("cam", "orb_scale", "orb_levels"))
def track_local_map_step(
    cam: Camera,
    T_init,
    local_pts: PointSet,
    frame: FrameData,
    prior_match_idx,
    radius,
    orb_scale: float = 1.2,
    orb_levels: int = 8,
    lil: LILPoseObs | None = None,
) -> TrackResult:
    """TrackLocalMap: match the local-map point set (wider, scale-checked),
    merge with the motion-model matches already held, re-optimize.

    ``prior_match_idx`` (M,) carries matches from the first pose solve for
    points that overlap the local set (-1 elsewhere); a fresh match replaces
    the prior only where one is found.
    """
    match_idx, visible = _match_points_to_frame(
        cam,
        T_init,
        local_pts,
        frame,
        radius,
        orb_scale,
        orb_levels,
        check_scale=True,
        ratio=0.95,
    )
    match_idx = jnp.where(match_idx >= 0, match_idx, prior_match_idx)
    sigma2 = scale_sigma2_arr(orb_scale, orb_levels)
    po = _pose_obs_from_matches(local_pts, frame, match_idx, sigma2)
    T_opt, inlier, chi2, lil_inlier = pose_optimization(cam, T_init, po, lil=lil)
    return _result(T_opt, match_idx, po, inlier, visible, lil, lil_inlier)
