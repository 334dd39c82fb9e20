"""Single-dispatch per-frame tracking against a device-resident snapshot.

Re-uploading the local-map PointSet every frame costs ~6 device dispatches
and ~25 host fetches per frame, so host orchestration would dominate the
device program. This module makes the per-frame hot path ONE device
dispatch + ONE small fetch:

- ``LocalSnapshot``: the tracker's view of the map (points, lines, LILs),
  uploaded once per keyframe event. Between keyframes the map is immutable
  (the backend only commits at KF boundaries), so the snapshot is exact —
  this is SURVEY §7.2's "tracker consumes the last-committed map snapshot",
  replacing the reference's Map::mMutexMapUpdate (Tracking.cc:284).
- ``frame_step``: extraction + stereo + line frontend + motion-window
  tracking + LIL plane association + local-map tracking + line matching +
  per-landmark found/visible accumulation, fused into one jit program.
  The host fetches a 24-float summary per frame; full frame arrays are
  fetched only on keyframe insertion.

Behavioral anchor: Tracking::Track (reference src/Tracking.cc:274-552).
Deliberate redesign vs the reference: TrackWithMotionModel matches against
the *local map* point set directly (the previous frame's points are a
subset of it); the separate frame-to-frame step exists in the reference
only because matching cost scales with the candidate count on a CPU.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from pslam.pipeline.frame_ops import (
    FrameData,
    FrameLineData,
    make_frame,
    make_frame_lines,
    make_frame_stereo,
)
from pslam.pipeline.track_ops import (
    PointSet,
    track_against_points,
    track_local_map_step,
)
from pslam.solver.lil import LILPoseObs


class LineSnap(NamedTuple):
    """Device snapshot of the local map-line set (capacity L)."""

    pos: jnp.ndarray  # (L, 6) world endpoints
    desc: jnp.ndarray  # (L, D)
    min_dist: jnp.ndarray  # (L,)
    max_dist: jnp.ndarray  # (L,)
    normal: jnp.ndarray  # (L, 3) mean viewing direction
    valid: jnp.ndarray  # (L,) bool


class LILSnap(NamedTuple):
    """Device snapshot of the map InsectLine table (capacity Q)."""

    state: jnp.ndarray  # (Q, 15) world 5-point state
    plane: jnp.ndarray  # (Q, 4) world plane (n, d), d >= 0
    valid: jnp.ndarray  # (Q,) bool


class LocalSnapshot(NamedTuple):
    pts: PointSet  # (M,)
    lines: LineSnap | None
    lils: LILSnap | None


class Acc(NamedTuple):
    """Device-resident found/visible accumulators, folded into the host map
    at every snapshot rebuild (MapPoint::IncreaseVisible/Found etc.)."""

    pt_vis: jnp.ndarray  # (M,) int32
    pt_found: jnp.ndarray  # (M,) int32
    ml_vis: jnp.ndarray  # (L,) int32
    ml_found: jnp.ndarray  # (L,) int32
    il_obs: jnp.ndarray  # (Q,) int32 distinct-frame plane associations


class StepOut(NamedTuple):
    T_cw: jnp.ndarray  # (4, 4) device pose — lets the NEXT frame_step chain
    # off it without any host fetch (depth-1 pipelined tracking)
    vel: jnp.ndarray  # (4, 4) device velocity T_cw @ inv(T_prev)
    summary: jnp.ndarray  # (24,) f32, see SUMMARY_* indices below
    match_point: jnp.ndarray  # (M,) feature idx per local point, -1 none
    inlier: jnp.ndarray  # (M,) bool
    line_match: jnp.ndarray  # (L,) frame-line slot per local line, -1 none
    lil_match: jnp.ndarray  # (QF,) snapshot LIL slot per frame LIL, -1 none
    fd: FrameData
    fl: FrameLineData | None
    acc: Acc


# summary vector layout
S_T = slice(0, 16)  # row-major 4x4 T_cw
S_INLIERS = 16  # final point inliers (accept gate, Tracking.cc:1400-1406)
S_MATCHES = 17  # matches fed to the final solve
S_WEIGHTED = 18  # points + 5*LIL inliers (Tracking.cc:1037,1281,1396)
S_TRACKED_CLOSE = 19  # close tracked features (NeedNewKeyFrame)
S_UNTRACKED_CLOSE = 20  # close untracked features
S_LINE_MATCHES = 21
S_LIL_ASSOC = 22
S_INLIERS_1 = 23  # inliers of the motion-window solve


def _project_uvz(cam, T_cw, X_w):
    Xc = X_w @ T_cw[:3, :3].T + T_cw[:3, 3]
    z = Xc[:, 2]
    zs = jnp.maximum(z, 1e-9)
    uv = jnp.stack(
        [cam.fx * Xc[:, 0] / zs + cam.cx, cam.fy * Xc[:, 1] / zs + cam.cy],
        axis=-1,
    )
    return uv, z


def _match_local_lines(cam, T_cw, ls: LineSnap, fl: FrameLineData, radius):
    """Device analogue of line_mapping.match_map_lines_to_view
    (LSDmatcher::SearchByProjection, add_src/LSDmatcher.cpp:112-260)."""
    from pslam.ops.line_match import match_lines_projection

    sp2, zs = _project_uvz(cam, T_cw, ls.pos[:, :3])
    ep2, ze = _project_uvz(cam, T_cw, ls.pos[:, 3:])
    okz = (zs > 0.05) & (ze > 0.05)
    W, H = float(cam.width), float(cam.height)
    in_img = (
        (sp2[:, 0] > -50) & (sp2[:, 0] < W + 50)
        & (sp2[:, 1] > -50) & (sp2[:, 1] < H + 50)
    )
    C = -T_cw[:3, :3].T @ T_cw[:3, 3]
    mid = 0.5 * (ls.pos[:, :3] + ls.pos[:, 3:])
    om = mid - C[None, :]
    dist = jnp.linalg.norm(om, axis=-1)
    band = (dist >= 0.8 * ls.min_dist) & (dist <= 1.2 * ls.max_dist)
    viewcos = jnp.sum(om * ls.normal, axis=-1) / jnp.maximum(dist, 1e-9)
    vmask = okz & in_img & band & (viewcos > 0.5) & ls.valid
    idx, _ = match_lines_projection(
        sp2, ep2, None, ls.desc, vmask,
        fl.sp, fl.ep, fl.desc, fl.valid, radius,
    )
    return idx, vmask


def _associate_lils(lil, T_cw, ils: LILSnap, a_th: float, d_th: float):
    """Device plane association (Map::AssociatePlanesByBoundary,
    Map.cc:204-272): frame LIL -> map InsectLine by normal angle + mean
    |point-plane distance| over the 5 structure points; best distance wins.
    Returns (LILPoseObs for the pose solve, il_match (QF,) snapshot slot)."""
    R, t = T_cw[:3, :3], T_cw[:3, 3]
    pts_c = jnp.stack(
        [lil.p1s, lil.p1e, lil.p2s, lil.p2e, lil.cross3d], axis=1
    )  # (QF, 5, 3)
    pts_w = (pts_c - t) @ R  # R^T (X_c - t)
    n_w = lil.plane[:, :3] @ R  # R^T n
    cos = jnp.abs(n_w @ ils.plane[:, :3].T)  # (QF, Q)
    d = jnp.abs(
        jnp.einsum("fpj,qj->fpq", pts_w, ils.plane[:, :3])
        + ils.plane[None, None, :, 3]
    ).mean(axis=1)  # (QF, Q)
    ok = (cos > a_th) & (d < d_th) & ils.valid[None, :] & lil.valid[:, None]
    dm = jnp.where(ok, d, jnp.inf)
    best = jnp.argmin(dm, axis=1)
    has = jnp.isfinite(jnp.min(dm, axis=1))
    il_match = jnp.where(has, best, -1)

    Q = ils.valid.shape[0]
    onehot = (il_match[:, None] == jnp.arange(Q)[None, :]).astype(jnp.float32)
    state = onehot @ ils.state  # exact one-hot gather
    obs = jnp.concatenate([lil.eq1, lil.eq2, lil.cross2d], axis=-1)
    return LILPoseObs(state=state, obs=obs, valid=has), il_match


@partial(jax.jit, static_argnames=("cfg",))
def frame_step(
    cfg,
    gray,
    depth,
    T_prev,
    velocity,
    motion_radius,
    snap: LocalSnapshot,
    acc: Acc,
) -> StepOut:
    """One frame of tracking (Tracking::Track, Tracking.cc:274-552) as a
    single device program. ``motion_radius`` is traced, so the host can
    re-dispatch the SAME compiled program with the widened window
    (Tracking.cc:1198-1203) when the first attempt returns few inliers."""
    cam, orb = cfg.camera, cfg.orb
    tcfg = cfg.tracking

    if cfg.sensor == "stereo":
        # ``depth`` carries the RIGHT image (see SlamConfig.sensor).
        fd = make_frame_stereo(gray, depth, cam, orb)
    else:
        fd = make_frame(gray, depth, cam, orb)
    fl = None
    if cfg.use_lines:
        fl = make_frame_lines(gray, depth, cam, cfg.lines, cfg.caps.frame_lils)

    T_pred = velocity @ T_prev
    # Motion-window step WITHOUT the scale/view-angle frustum gates
    # (TrackWithMotionModel projects last-frame points with only a level
    # window, Tracking.cc:1164; the gates belong to the local-map step).
    res1 = track_against_points(
        cam, T_pred, snap.pts, fd, motion_radius, orb.scale, orb.levels,
        check_scale=False,
    )

    lil_obs = None
    lil_match = jnp.full(cfg.caps.frame_lils, -1, jnp.int32)
    if cfg.use_lines and cfg.use_lils and snap.lils is not None:
        lil_obs, lil_match = _associate_lils(
            fl.lil, res1.T_cw, snap.lils,
            cfg.plane_assoc.a_th, cfg.plane_assoc.d_th,
        )

    prior = jnp.where(res1.inlier & (res1.match_point >= 0),
                      res1.match_point, -1)
    res2 = track_local_map_step(
        cam, res1.T_cw, snap.pts, fd, prior, tcfg.local_match_radius,
        orb.scale, orb.levels, lil=lil_obs,
    )

    L = acc.ml_vis.shape[0]
    line_match = jnp.full(L, -1, jnp.int32)
    line_vis = jnp.zeros(L, bool)
    if cfg.use_lines and snap.lines is not None:
        line_match, line_vis = _match_local_lines(
            cam, res2.T_cw, snap.lines, fl, radius=8.0
        )

    # --- keyframe-decision counts (NeedNewKeyFrame, Tracking.cc:1452) ------
    matched = (res2.match_point >= 0) & res2.inlier
    sel = jnp.where(matched, res2.match_point, -1)
    N = fd.valid.shape[0]
    feat_has = jnp.any(sel[:, None] == jnp.arange(N)[None, :], axis=0)
    close = (fd.depth > 0) & (fd.depth < cfg.th_depth) & fd.valid
    tracked_close = jnp.sum((feat_has & close).astype(jnp.int32))
    untracked_close = jnp.sum((~feat_has & close).astype(jnp.int32))

    # --- found/visible accumulation ----------------------------------------
    Q = acc.il_obs.shape[0]
    il_hit = jnp.any(
        lil_match[:, None] == jnp.arange(Q)[None, :], axis=0
    ).astype(jnp.int32)
    acc2 = Acc(
        pt_vis=acc.pt_vis + res2.visible.astype(jnp.int32),
        pt_found=acc.pt_found + matched.astype(jnp.int32),
        ml_vis=acc.ml_vis + line_vis.astype(jnp.int32),
        ml_found=acc.ml_found + (line_match >= 0).astype(jnp.int32),
        il_obs=acc.il_obs + il_hit,
    )

    summary = jnp.concatenate(
        [
            res2.T_cw.reshape(16),
            jnp.stack(
                [
                    res2.n_inliers.astype(jnp.float32),
                    res2.n_matches.astype(jnp.float32),
                    res2.n_weighted.astype(jnp.float32),
                    tracked_close.astype(jnp.float32),
                    untracked_close.astype(jnp.float32),
                    jnp.sum((line_match >= 0).astype(jnp.int32)).astype(
                        jnp.float32
                    ),
                    jnp.sum((lil_match >= 0).astype(jnp.int32)).astype(
                        jnp.float32
                    ),
                    res1.n_inliers.astype(jnp.float32),
                ]
            ),
        ]
    )
    return StepOut(
        T_cw=res2.T_cw,
        vel=res2.T_cw @ jnp.linalg.inv(T_prev),
        summary=summary,
        match_point=res2.match_point,
        inlier=res2.inlier,
        line_match=line_match,
        lil_match=lil_match,
        fd=fd,
        fl=fl,
        acc=acc2,
    )


# ---------------------------------------------------------------------------
# Host-side snapshot construction


def make_acc(cfg) -> Acc:
    M = cfg.caps.local_points
    L = cfg.caps.local_lines
    Q = cfg.caps.local_lils
    return Acc(
        pt_vis=jnp.zeros(M, jnp.int32),
        pt_found=jnp.zeros(M, jnp.int32),
        ml_vis=jnp.zeros(L, jnp.int32),
        ml_found=jnp.zeros(L, jnp.int32),
        il_obs=jnp.zeros(Q, jnp.int32),
    )


def build_point_set(m, mp_ids: np.ndarray, cap: int) -> PointSet:
    """Gather + pad a device PointSet for the given map-point ids."""
    n = min(len(mp_ids), cap)
    mp_ids = np.asarray(mp_ids, np.int64)[:n]
    pos = np.zeros((cap, 3), np.float32)
    desc = np.zeros((cap, 32), np.uint8)
    level = np.zeros(cap, np.int32)
    angle = np.zeros(cap, np.float32)
    mind = np.zeros(cap, np.float32)
    maxd = np.full(cap, 1e9, np.float32)
    normal = np.zeros((cap, 3), np.float32)
    valid = np.zeros(cap, bool)
    if n:
        pos[:n] = m.mp_pos[mp_ids]
        desc[:n] = m.mp_desc[mp_ids]
        mind[:n] = m.mp_min_dist[mp_ids]
        maxd[:n] = m.mp_max_dist[mp_ids]
        normal[:n] = m.mp_normal[mp_ids]
        valid[:n] = m.mp_valid[mp_ids]
        level[:n] = m.mp_level[mp_ids]
        angle[:n] = m.mp_angle[mp_ids]
    return PointSet(
        pos=jnp.asarray(pos),
        desc=jnp.asarray(desc),
        level=jnp.asarray(level),
        angle=jnp.asarray(angle),
        min_dist=jnp.asarray(mind),
        max_dist=jnp.asarray(maxd),
        normal=jnp.asarray(normal),
        valid=jnp.asarray(valid),
    )


def build_snapshot(m, cfg, pt_ids, ml_ids, il_ids) -> LocalSnapshot:
    """Upload the tracker's local-map view. Called at keyframe events only
    (insertion, BA commit, loop correction, relocalization, reset)."""
    pts = build_point_set(m, pt_ids, cfg.caps.local_points)

    lines = None
    lils = None
    if cfg.use_lines:
        L = cfg.caps.local_lines
        n = min(len(ml_ids), L)
        ml = np.asarray(ml_ids, np.int64)[:n]
        D = m.ml_desc.shape[1]
        pos = np.zeros((L, 6), np.float32)
        desc = np.zeros((L, D), np.float32)
        mind = np.zeros(L, np.float32)
        maxd = np.full(L, 1e9, np.float32)
        normal = np.zeros((L, 3), np.float32)
        lvalid = np.zeros(L, bool)
        if n:
            pos[:n] = m.ml_pos[ml]
            desc[:n] = m.ml_desc[ml]
            mind[:n] = m.ml_min_dist[ml]
            maxd[:n] = m.ml_max_dist[ml]
            normal[:n] = m.ml_normal[ml]
            lvalid[:n] = m.ml_valid[ml]
        lines = LineSnap(
            pos=jnp.asarray(pos),
            desc=jnp.asarray(desc),
            min_dist=jnp.asarray(mind),
            max_dist=jnp.asarray(maxd),
            normal=jnp.asarray(normal),
            valid=jnp.asarray(lvalid),
        )
        if cfg.use_lils:
            Q = cfg.caps.local_lils
            nq = min(len(il_ids), Q)
            il = np.asarray(il_ids, np.int64)[:nq]
            state = np.zeros((Q, 15), np.float32)
            plane = np.zeros((Q, 4), np.float32)
            plane[:, 3] = 1e9  # far dummy plane: never associates
            qvalid = np.zeros(Q, bool)
            if nq:
                state[:nq] = m.il_state[il]
                plane[:nq] = m.il_plane[il]
                qvalid[:nq] = m.il_valid[il]
            lils = LILSnap(
                state=jnp.asarray(state),
                plane=jnp.asarray(plane),
                valid=jnp.asarray(qvalid),
            )
    return LocalSnapshot(pts=pts, lines=lines, lils=lils)
