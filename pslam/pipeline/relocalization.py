"""Relocalization: BoW candidate search + RANSAC pose recovery + refine.

Replaces Tracking::Relocalization (reference Tracking.cc:2031-2180) and the
role of PnPsolver (src/PnPsolver.cc): BoW-bucketed descriptor matching
against candidate keyframes (ORBmatcher::SearchByBoW, ORBmatcher.cc:159),
a fixed-budget RANSAC pose hypothesis, pose optimization, and a coarse
projection re-search when inliers are scarce (ORBmatcher.cc:1472 behavior
via a second track_against_points pass).

The RANSAC stage uses 3-point SE3 alignment on depth-backprojected frame
points (solver/horn.py) rather than EPnP — the RGB-D depth channel makes the
3D-3D minimal problem available and it batches onto the device with a
plain vmap. Candidates are processed one fused dispatch each.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from pslam.geometry import Camera
from pslam.ops.bow import bow_group_mask
from pslam.ops.match import (
    TH_LOW,
    hamming_matrix,
    mutual_nn_match,
    rotation_consistency_mask,
)
from pslam.pipeline.frame_ops import FrameData
from pslam.solver.horn import se3_ransac_3d3d
from pslam.solver.pose_opt import PoseObs, pose_optimization


class RelocStepResult(NamedTuple):
    T_cw: jnp.ndarray  # (4, 4)
    inlier: jnp.ndarray  # (Nkf,) per-KF-feature inlier after pose opt
    match_idx: jnp.ndarray  # (Nkf,) frame feature per KF feature, -1 none
    n_inliers: jnp.ndarray  # () int32
    n_ransac: jnp.ndarray  # () int32 RANSAC support


@partial(jax.jit, static_argnames=("cam",))
def reloc_bow_step(
    cam: Camera,
    kf_mp_pos,  # (N, 3) world position of the KF feature's map point
    kf_mp_valid,  # (N,) bool: feature has a live map point
    kf_desc,  # (N, 32)
    kf_angle,  # (N,)
    kf_node,  # (N,) BoW node ids (FeatureVector bucket)
    frame: FrameData,
    f_node,  # (N,) frame BoW node ids
    sigma2,  # (levels,)
    key,
) -> RelocStepResult:
    """One relocalization attempt against one candidate KF (one dispatch):
    SearchByBoW matching -> 3-point RANSAC on depth-backprojected matches ->
    LM pose optimization (Tracking.cc:2088-2130)."""
    dist = hamming_matrix(kf_desc, frame.desc)
    bucket = bow_group_mask(kf_node, f_node)
    idx, _ = mutual_nn_match(
        dist,
        valid_a=kf_mp_valid,
        valid_b=frame.valid,
        max_dist=TH_LOW,
        ratio=0.75,  # SearchByBoW mfNNratio for reloc (Tracking.cc:2060)
        extra_mask=bucket,
    )
    fi = jnp.maximum(idx, 0)
    keep = rotation_consistency_mask(kf_angle, frame.angle[fi], idx >= 0)
    idx = jnp.where(keep, idx, -1)
    m = idx >= 0
    fi = jnp.maximum(idx, 0)

    # RANSAC pose from 3D-3D: map point (world) <-> depth backprojection
    # (cam). When too few matched features carry depth (depth holes), fall
    # back to uv-only PnP RANSAC (the reference always uses EPnP,
    # PnPsolver.cc:165; here the 3D-3D solve is stronger when depth exists
    # and PnP covers the depth-sparse case — VERDICT r3 item 9).
    from pslam.solver.pnp import pnp_ransac_2d3d

    X_c = frame.xyz_c[fi]
    has3d = frame.depth[fi] > 0
    n3d = jnp.sum((m & has3d).astype(jnp.int32))
    key3, key2 = jax.random.split(key)
    T0, n_ransac = jax.lax.cond(
        n3d >= 12,
        lambda: (lambda r: (r[0], r[2]))(
            se3_ransac_3d3d(kf_mp_pos, X_c, m & has3d, key3, n_trials=256)
        ),
        lambda: (lambda r: (r[0], r[2]))(
            pnp_ransac_2d3d(
                cam, kf_mp_pos, frame.uv[fi], m, key2, n_trials=256
            )
        ),
    )

    # Pose optimization on all BoW matches (stereo reprojection residuals).
    obs = jnp.stack([frame.uv[fi, 0], frame.uv[fi, 1], frame.ur[fi]], axis=-1)
    inv_s2 = 1.0 / sigma2[jnp.clip(frame.level[fi], 0, sigma2.shape[0] - 1)]
    po = PoseObs(X_w=kf_mp_pos, obs=obs, inv_sigma2=inv_s2, valid=m)
    T_opt, inlier, _, _ = pose_optimization(cam, T0, po)
    return RelocStepResult(
        T_cw=T_opt,
        inlier=inlier,
        match_idx=idx,
        n_inliers=jnp.sum(inlier.astype(jnp.int32)),
        n_ransac=n_ransac,
    )


def relocalize(system, hf, fd: FrameData):
    """Host orchestration (Tracking::Relocalization, Tracking.cc:2031):
    detect candidates, try each with one fused device step, then refine the
    best via a coarse projection search; accept at >= accept_th inliers
    (Tracking.cc:2173 uses 50). Returns True and fills hf.T_cw / hf.feat_mp
    on success."""
    cfg = system.cfg
    m = system.map
    db = system.kf_db
    if db is None or m.n_kf == 0:
        return False
    bow_q, _, node_q = db.compute_bow(hf.desc, hf.valid)
    cands = db.detect_relocalization_candidates(bow_q, m)
    if len(cands) == 0:
        return False

    sigma2 = np.asarray(
        [(cfg.orb.scale**l) ** 2 for l in range(cfg.orb.levels)], np.float32
    )
    accept_th = cfg.tracking.reloc_accept_inliers
    min_bow_inliers = 15  # Tracking.cc:2074 (nmatches < 15 -> skip)

    best = None
    for rank, kf in enumerate(cands[: cfg.tracking.reloc_max_candidates]):
        kf = int(kf)
        mp = m.kf_feat_mp[kf]
        mp_valid = (mp >= 0) & m.mp_valid[np.maximum(mp, 0)]
        mp_pos = m.mp_pos[np.maximum(mp, 0)] * mp_valid[:, None]
        res = reloc_bow_step(
            cfg.camera,
            jnp.asarray(mp_pos.astype(np.float32)),
            jnp.asarray(mp_valid),
            jnp.asarray(m.kf_desc[kf]),
            jnp.asarray(m.kf_angle[kf]),
            jnp.asarray(db.node[kf]),
            fd,
            jnp.asarray(node_q),
            jnp.asarray(sigma2),
            jax.random.PRNGKey(hf.frame_id * 131 + rank),
        )
        n_in = int(res.n_inliers)
        if n_in < min_bow_inliers:
            continue
        if best is None or n_in > best[0]:
            best = (n_in, kf, res)

    if best is None:
        return False
    n_in, kf, res = best

    # Coarse projection re-search around the recovered pose + re-optimize
    # (SearchByProjection coarse->fine, Tracking.cc:2135-2165). The search
    # set is the candidate KF's covisible NEIGHBOURHOOD (local-map style),
    # not just its own points — recovery often happens a little off the
    # candidate's exact viewpoint and the wide window must have map points
    # to find there.
    from pslam.pipeline.track_ops import (
        track_against_points,
        track_local_map_step,
    )

    neigh = [kf] + [int(j) for j in m.best_covisible(kf, 10)]
    mp = m.kf_feat_mp[np.asarray(neigh)].reshape(-1)
    mp_ids = np.unique(mp[mp >= 0])
    mp_ids = mp_ids[m.mp_valid[mp_ids]]
    pts = system._point_set(mp_ids, cap=cfg.caps.local_points)
    res2 = track_against_points(
        cfg.camera, res.T_cw, pts, fd, 10.0, cfg.orb.scale, cfg.orb.levels
    )
    n_final = int(res2.n_inliers)
    match_point = np.asarray(res2.match_point)
    inl = np.asarray(res2.inlier)
    T_final = res2.T_cw
    if accept_th > n_final >= 30:
        # Narrow second pass from the refined pose, keeping found matches
        # as priors (the window-3 re-search of Tracking.cc:2146-2161).
        prior = jnp.asarray(np.where(match_point >= 0, match_point, -1))
        res3 = track_local_map_step(
            cfg.camera, res2.T_cw, pts, fd, prior, 3.0,
            cfg.orb.scale, cfg.orb.levels,
        )
        if int(res3.n_inliers) > n_final:
            n_final = int(res3.n_inliers)
            match_point = np.asarray(res3.match_point)
            inl = np.asarray(res3.inlier)
            T_final = res3.T_cw
    if n_final < accept_th:
        return False

    hf.T_cw = np.asarray(T_final)
    sel = np.flatnonzero((match_point >= 0) & inl)[: len(mp_ids)]
    sel = sel[sel < len(mp_ids)]
    hf.feat_mp[match_point[sel]] = mp_ids[sel]
    system.ref_kf = kf
    system.stats["relocs"] = system.stats.get("relocs", 0) + 1
    return True
