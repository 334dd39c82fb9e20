"""Global bundle adjustment over the whole map.

Replaces Optimizer::GlobalBundleAdjustemnt / BundleAdjustment (reference
src/Optimizer.cc:41-237, invoked from LoopClosing::RunGlobalBundleAdjustment,
LoopClosing.cc:645-750): all keyframes free except KF 0, all map points
marginalized, 10-20 LM iterations. Reuses the Schur-complement solver of
solver/local_ba.py with larger fixed capacities; keyframes beyond the free
capacity stay fixed (oldest first, which the essential graph has already
placed consistently).
"""

from __future__ import annotations

import numpy as np

from pslam.models.map_state import MapState
from pslam.solver.local_ba import BAProblem, local_bundle_adjustment
from pslam.utils.config import SlamConfig


def assemble_global_ba(m: MapState, cfg: SlamConfig):
    """Build a BAProblem over all keyframes/points. Returns
    (prob, cam_ids, pt_ids, e_feat, n_e) or None."""
    caps = cfg.caps
    K = m.n_kf
    if K < 2:
        return None
    alive = np.flatnonzero(m.kf_valid[:K])
    alive = alive[np.argsort(m.kf_frame_id[alive], kind="stable")]
    cam_ids = [int(k) for k in alive][: caps.gba_cams]
    if len(cam_ids) < 2:
        return None
    # Free: everything except the oldest KF (gauge; Optimizer.cc:119
    # setFixed(id==0)), capped; newest keyframes get priority for free slots.
    n_free_cap = caps.gba_free
    free = cam_ids[1:]
    if len(free) > n_free_cap:
        free = free[-n_free_cap:]
    free_set = set(free)

    pt_ids = m.local_map_points(np.asarray(cam_ids), caps.gba_points)
    if len(pt_ids) == 0:
        return None
    pt_slot = np.full(m.mp_valid.shape[0], -1, np.int64)
    pt_slot[pt_ids] = np.arange(len(pt_ids))

    sigma2 = np.asarray(
        [(cfg.orb.scale**l) ** 2 for l in range(cfg.orb.levels)], np.float32
    )
    e_cam, e_pt, e_obs, e_is2, e_feat = [], [], [], [], []
    for s, k in enumerate(cam_ids):
        mp = m.kf_feat_mp[k]
        sel = np.flatnonzero((mp >= 0) & (pt_slot[np.maximum(mp, 0)] >= 0))
        if len(sel) == 0:
            continue
        e_cam.append(np.full(len(sel), s, np.int32))
        e_pt.append(pt_slot[mp[sel]].astype(np.int32))
        uv = m.kf_uv[k, sel]
        ur = m.kf_ur[k, sel]
        e_obs.append(np.concatenate([uv, ur[:, None]], axis=1).astype(np.float32))
        e_is2.append(
            1.0 / sigma2[np.clip(m.kf_level[k, sel], 0, len(sigma2) - 1)]
        )
        e_feat.append(np.stack([np.full(len(sel), k), sel], axis=1))
    if not e_cam:
        return None
    e_cam = np.concatenate(e_cam)
    e_pt = np.concatenate(e_pt)
    e_obs = np.concatenate(e_obs)
    e_is2 = np.concatenate(e_is2)
    e_feat = np.concatenate(e_feat)

    E = caps.gba_edges
    n_e = min(len(e_cam), E)
    if len(e_cam) > E:
        keep = np.random.default_rng(0).choice(len(e_cam), E, replace=False)
        e_cam, e_pt, e_obs, e_is2, e_feat = (
            e_cam[keep], e_pt[keep], e_obs[keep], e_is2[keep], e_feat[keep],
        )

    C = caps.gba_cams
    cam_arr = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    free_slot = np.full(C, -1, np.int32)
    fs = 0
    for s, k in enumerate(cam_ids):
        cam_arr[s] = m.kf_pose[k]
        if k in free_set:
            free_slot[s] = fs
            fs += 1

    def pad(a, shape, fill=0):
        out = np.full(shape, fill, a.dtype)
        out[: len(a)] = a
        return out

    P = caps.gba_points
    prob = BAProblem(
        T_cw=cam_arr,
        free_slot=free_slot,
        X_w=pad(m.mp_pos[pt_ids], (P, 3)),
        point_valid=pad(np.ones(len(pt_ids), bool), (P,)),
        cam_idx=pad(e_cam, (E,)),
        pt_idx=pad(e_pt, (E,)),
        obs=pad(e_obs, (E, 3)),
        inv_sigma2=pad(e_is2, (E,), 1.0),
        edge_valid=pad(np.ones(n_e, bool), (E,)),
    )
    return prob, cam_ids, pt_ids, e_feat, n_e


def run_global_ba(m: MapState, cfg: SlamConfig, schedule=(10, 10)):
    """Assemble + solve + write back. Returns True if a solve ran.

    With cfg.distributed and a multi-device mesh the solve is the
    edge-sharded variant (parallel/sharded_ba.py) — the reference's global
    BA is single-threaded g2o (Optimizer.cc:41-237); here its edge set is
    the sharding axis and the reduced camera system is psum-assembled."""
    import jax

    from pslam.pipeline.local_mapping import write_back_ba

    out = assemble_global_ba(m, cfg)
    if out is None:
        return False
    prob, cam_ids, pt_ids, e_feat, n_e = out
    if cfg.distributed and len(jax.devices()) > 1:
        from pslam.parallel.sharded_ba import (
            make_ba_mesh,
            sharded_local_bundle_adjustment,
        )

        result = sharded_local_bundle_adjustment(
            cfg.camera, prob, cfg.caps.gba_free, make_ba_mesh(),
            schedule=schedule,
        )
    else:
        result = local_bundle_adjustment(
            cfg.camera, prob, cfg.caps.gba_free, schedule=schedule
        )
    write_back_ba(
        m, result, cam_ids, pt_ids, e_feat, n_e, np.asarray(prob.free_slot)
    )
    return True
