"""Local mapping (backend): BA problem assembly + write-back, point culling.

Replaces the LocalMapping thread (reference src/LocalMapping.cc): runs
synchronously after each keyframe insertion (the reference's thread overlap
becomes async dispatch later). The numeric core is solver/local_ba.py; this
module does the host-side gather/scatter between MapState and the
fixed-capacity BAProblem.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from pslam.geometry import Camera
from pslam.models.map_state import MapState
from pslam.solver.local_ba import BAProblem
from pslam.utils.config import SlamConfig


def assemble_local_ba(map_state: MapState, kf_idx: int, cfg: SlamConfig):
    """Build a BAProblem around keyframe ``kf_idx``.

    Free cameras: ``kf_idx`` + its best covisible keyframes (1-hop local
    window, Optimizer.cc:2112); fixed: other observers of the local points
    (Optimizer.cc:2125). KF 0 is always fixed (gauge).
    Returns (prob, cam_ids (C,), pt_ids (P,), edge meta) or None if there is
    nothing to optimize.
    """
    caps = cfg.caps
    n_free_cap = caps.ba_free

    # KF 0 always stays fixed (gauge anchor, like the reference's pKF->mnId==0
    # setFixed at Optimizer.cc:2121).
    covis = map_state.best_covisible(kf_idx, n_free_cap - 1)
    free_ids = [kf_idx] + [int(j) for j in covis if j != kf_idx and j != 0]
    free_ids = free_ids[:n_free_cap]
    free_set = set(free_ids)

    # Local points: union over free KFs.
    pt_ids = map_state.local_map_points(np.asarray(free_ids), caps.ba_points)
    if len(pt_ids) == 0:
        return None
    pt_slot = np.full(map_state.mp_valid.shape[0], -1, np.int64)
    pt_slot[pt_ids] = np.arange(len(pt_ids))

    # Cameras: free + fixed observers.
    feat_mp = map_state.kf_feat_mp[: map_state.n_kf]
    observes_local = (pt_slot[np.maximum(feat_mp, 0)] >= 0) & (feat_mp >= 0)
    obs_count = observes_local.sum(axis=1)
    fixed_ids = [
        k
        for k in np.flatnonzero(obs_count > 0)
        if k not in free_set and map_state.kf_valid[k]
    ]
    # Always pin the oldest involved KF; truncate to capacity.
    cam_ids = free_ids + fixed_ids[: caps.ba_cams - len(free_ids)]
    if len(free_ids) == len(cam_ids) and len(cam_ids) > 1:
        # No fixed camera at all -> fix the oldest free one for gauge.
        oldest = min(free_ids, key=lambda k: int(map_state.kf_frame_id[k]))
        free_ids = [k for k in free_ids if k != oldest]
        free_set = set(free_ids)

    C = caps.ba_cams
    cam_arr = np.zeros((C, 4, 4), np.float32)
    cam_arr[:] = np.eye(4)
    free_slot = np.full(C, -1, np.int32)
    for s, k in enumerate(cam_ids):
        cam_arr[s] = map_state.kf_pose[k]
    fs = 0
    for s, k in enumerate(cam_ids):
        if k in free_set:
            free_slot[s] = fs
            fs += 1

    # Edges.
    sigma2 = np.asarray(
        [(cfg.orb.scale**l) ** 2 for l in range(cfg.orb.levels)], np.float32
    )
    e_cam, e_pt, e_obs, e_is2, e_feat = [], [], [], [], []
    for s, k in enumerate(cam_ids):
        mp = map_state.kf_feat_mp[k]
        sel = np.flatnonzero((mp >= 0) & (pt_slot[np.maximum(mp, 0)] >= 0))
        if len(sel) == 0:
            continue
        e_cam.append(np.full(len(sel), s, np.int32))
        e_pt.append(pt_slot[mp[sel]].astype(np.int32))
        uv = map_state.kf_uv[k, sel]
        ur = map_state.kf_ur[k, sel]
        e_obs.append(
            np.concatenate([uv, ur[:, None]], axis=1).astype(np.float32)
        )
        e_is2.append(1.0 / sigma2[np.clip(map_state.kf_level[k, sel], 0, len(sigma2) - 1)])
        e_feat.append(np.stack([np.full(len(sel), k), sel], axis=1))

    if not e_cam:
        return None
    e_cam = np.concatenate(e_cam)
    e_pt = np.concatenate(e_pt)
    e_obs = np.concatenate(e_obs)
    e_is2 = np.concatenate(e_is2)
    e_feat = np.concatenate(e_feat)

    E = caps.ba_edges
    n_e = min(len(e_cam), E)
    if len(e_cam) > E:
        import logging

        logging.getLogger(__name__).warning(
            "local BA edge capacity: dropping %d of %d edges (caps.ba_edges=%d)",
            len(e_cam) - E, len(e_cam), E,
        )
        keep = np.random.default_rng(0).choice(len(e_cam), E, replace=False)
        e_cam, e_pt, e_obs, e_is2, e_feat = (
            e_cam[keep], e_pt[keep], e_obs[keep], e_is2[keep], e_feat[keep],
        )
        n_e = E

    def pad(a, shape, fill=0):
        out = np.full(shape, fill, a.dtype)
        out[: len(a)] = a
        return out

    # Shape buckets: pad to the smallest power-of-two capacity that fits
    # (min 2048/1024) instead of always the worst case — the solve cost
    # scales with E and the (E, P) scatter one-hot, and typical local
    # windows fill a fraction of the caps. Each bucket is one compiled
    # program (few variants, reused across the run).
    E_b = max(2048, 1 << int(np.ceil(np.log2(max(n_e, 1)))))
    E_b = min(E_b, E)
    P_b = max(1024, 1 << int(np.ceil(np.log2(max(len(pt_ids), 1)))))
    P_b = min(P_b, caps.ba_points)
    prob = BAProblem(
        T_cw=cam_arr,
        free_slot=free_slot,
        X_w=pad(map_state.mp_pos[pt_ids], (P_b, 3)),
        point_valid=pad(np.ones(len(pt_ids), bool), (P_b,)),
        cam_idx=pad(e_cam[:E_b], (E_b,)),
        pt_idx=pad(e_pt[:E_b], (E_b,)),
        obs=pad(e_obs[:E_b], (E_b, 3)),
        inv_sigma2=pad(e_is2[:E_b], (E_b,), 1.0),
        edge_valid=pad(np.ones(min(n_e, E_b), bool), (E_b,)),
    )
    return prob, cam_ids, pt_ids, e_feat, n_e


def write_back_ba(map_state: MapState, result, cam_ids, pt_ids, e_feat, n_e, free_slot):
    """Write optimized poses/points into the map and erase outlier
    observations (Optimizer.cc:2482-2532)."""
    T_opt, X_opt, inlier, _ = result
    T_opt = np.asarray(T_opt)
    X_opt = np.asarray(X_opt)
    inlier = np.asarray(inlier)
    for s, k in enumerate(cam_ids):
        if free_slot[s] >= 0:
            map_state.kf_pose[k] = T_opt[s]
    map_state.mp_pos[pt_ids] = X_opt[: len(pt_ids)]
    # Outlier observation erasure.
    bad = ~inlier[:n_e]
    if bad.any():
        kf_i = e_feat[:n_e][bad, 0]
        ft_i = e_feat[:n_e][bad, 1]
        mp_ids = map_state.kf_feat_mp[kf_i, ft_i]
        map_state.kf_feat_mp[kf_i, ft_i] = -1
        np.add.at(map_state.mp_n_obs, mp_ids[mp_ids >= 0], -1)


def _kf_view(m: MapState, k: int, free_mask):
    """Package KF ``k``'s features as a device KFView for the triangulator."""
    from pslam.ops.triangulate import KFView

    return KFView(
        T_cw=jnp.asarray(m.kf_pose[k]),
        uv=jnp.asarray(m.kf_uv[k]),
        ur=jnp.asarray(m.kf_ur[k]),
        depth=jnp.asarray(m.kf_feat_depth[k]),
        level=jnp.asarray(m.kf_level[k]),
        angle=jnp.asarray(m.kf_angle[k]),
        desc=jnp.asarray(m.kf_desc[k]),
        free=jnp.asarray(free_mask),
    )


def dispatch_triangulation(m: MapState, kf: int, cfg: SlamConfig):
    """Dispatch the epipolar triangulation of the new KF against its top-10
    covisible neighbours (LocalMapping::CreateNewMapPoints,
    LocalMapping.cc:275-520 + ORBmatcher::SearchForTriangulation,
    ORBmatcher.cc:657) WITHOUT fetching: returns a pending record whose
    device handles are committed later (commit_triangulation). This is the
    analogue of the reference's LocalMapping-thread overlap
    (System.cc:86-113): the keyframe's frame never blocks on the backend
    device work. Returns None if there is nothing to triangulate."""
    from pslam.ops.triangulate import KFView, epipolar_triangulate_batch

    C_kf = m.kf_camera_center(kf)
    neighbors = [
        int(nkf)
        for nkf in m.best_covisible(kf, 10)
        # Baseline gate (stereo/RGB-D branch, LocalMapping.cc:325-333).
        if np.linalg.norm(m.kf_camera_center(int(nkf)) - C_kf)
        >= cfg.camera.baseline
    ]
    if len(neighbors) == 0:
        return None
    free1 = (m.kf_feat_mp[kf] < 0) & m.kf_feat_valid[kf]
    if not free1.any():
        return None

    # Pad the neighbour axis to a constant 10 (one compiled shape); pad
    # slots repeat the first neighbour with free=False, so they match
    # nothing.
    NB = 10
    nb = np.asarray((neighbors + neighbors[:1] * NB)[:NB])
    free2 = (m.kf_feat_mp[nb] < 0) & m.kf_feat_valid[nb]
    free2[len(neighbors):] = False
    views2 = KFView(
        T_cw=jnp.asarray(m.kf_pose[nb]),
        uv=jnp.asarray(m.kf_uv[nb]),
        ur=jnp.asarray(m.kf_ur[nb]),
        depth=jnp.asarray(m.kf_feat_depth[nb]),
        level=jnp.asarray(m.kf_level[nb]),
        angle=jnp.asarray(m.kf_angle[nb]),
        desc=jnp.asarray(m.kf_desc[nb]),
        free=jnp.asarray(free2),
    )
    handles = epipolar_triangulate_batch(
        cfg.camera, _kf_view(m, kf, free1), views2,
        cfg.orb.scale, cfg.orb.levels,
    )
    return {
        "kf": kf,
        "kf_seq": int(m.kf_seq[kf]),
        "neighbors": neighbors,
        "nb_seq": [int(m.kf_seq[n]) for n in neighbors],
        "free1": free1,
        "handles": handles,
    }


def commit_triangulation(m: MapState, pend, cfg: SlamConfig) -> int:
    """Fetch + apply a dispatched triangulation (one batched transfer). The
    map may have moved on since dispatch (a whole keyframe interval in the
    async schedule): stale bindings are guarded by KF sequence checks and a
    re-check that each feature slot is STILL free; the world positions were
    computed with the poses at dispatch time, whose subsequent local-BA
    delta is sub-millimetre (same temporal fuzz the reference's thread
    split accepts). The host applies per-neighbour results greedily (a
    feature bound by an earlier neighbour is skipped for later ones,
    matching the reference's sequential free-set update)."""
    kf = pend["kf"]
    if not m.kf_valid[kf] or int(m.kf_seq[kf]) != pend["kf_seq"]:
        return 0
    idx2_b, X_w_b, ok_b = jax.device_get(pend["handles"])
    free1 = pend["free1"] & (m.kf_feat_mp[kf] < 0)

    created_ids = []
    for j, nkf in enumerate(pend["neighbors"]):
        if not m.kf_valid[nkf] or int(m.kf_seq[nkf]) != pend["nb_seq"][j]:
            continue  # neighbour culled (and possibly recycled) meanwhile
        ok = ok_b[j] & free1
        # The neighbour-side feature must also still be unbound.
        ok &= np.where(ok, m.kf_feat_mp[nkf][idx2_b[j]] < 0, False)
        sel1 = np.flatnonzero(ok)
        if len(sel1) == 0:
            continue
        ids = m.create_points_from_depth(kf, sel1, X_w_b[j][sel1])
        m.add_point_obs(nkf, idx2_b[j][sel1], ids)
        free1[sel1] = False
        created_ids.append(ids)
    if not created_ids:
        return 0
    ids = np.concatenate(created_ids)
    m._update_covisibility(kf)
    m.update_point_stats(ids)
    return len(ids)


def create_new_map_points(m: MapState, kf: int, cfg: SlamConfig) -> int:
    """Synchronous dispatch+commit wrapper (tests / non-pipelined callers)."""
    pend = dispatch_triangulation(m, kf, cfg)
    return 0 if pend is None else commit_triangulation(m, pend, cfg)


@partial(jax.jit, static_argnames=("cam", "scale", "levels"))
def _fuse_match_kernel(
    cam: Camera, T_cw, pos, desc, level, min_dist, max_dist_arr, normal, valid,
    f_uv, f_ur, f_level, f_desc, f_valid, scale: float, levels: int,
):
    """Project candidate points into a KF and match against its features
    (ORBmatcher::Fuse, ORBmatcher.cc:825): radius 3*sigma(predicted level),
    level window [pred-1, pred+1], Hamming <= TH_LOW, chi^2 reprojection."""
    from pslam.ops.match import (
        TH_LOW,
        hamming_matrix,
        level_window_mask,
        mutual_nn_match,
        window_mask,
    )
    from pslam.pipeline.track_ops import (
        PointSet,
        _project_points,
        _scale_visibility,
    )

    pts = PointSet(
        pos=pos, desc=desc, level=level, angle=jnp.zeros_like(min_dist),
        min_dist=min_dist, max_dist=max_dist_arr, normal=normal, valid=valid,
    )
    uvr, z, visible = _project_points(cam, T_cw, pts)
    band_ok, pred_level = _scale_visibility(cam, T_cw, pts, scale, levels)
    visible = visible & band_ok
    sfac = jnp.asarray([scale**l for l in range(levels)], jnp.float32)
    r = 3.0 * sfac[jnp.clip(pred_level, 0, levels - 1)]
    box = window_mask(uvr[:, :2], f_uv, r)
    lvl_ok = level_window_mask(pred_level, f_level, -1, 1)
    dist = hamming_matrix(desc, f_desc)
    idx, d = mutual_nn_match(
        dist, valid_a=visible, valid_b=f_valid, max_dist=TH_LOW, ratio=1.0,
        extra_mask=box & lvl_ok,
    )
    # chi^2 reprojection gate (mono 5.99, stereo 7.8; ORBmatcher.cc:886-917).
    fi = jnp.maximum(idx, 0)
    s2 = sfac[jnp.clip(f_level[fi], 0, levels - 1)] ** 2
    e_uv = jnp.sum((uvr[:, :2] - f_uv[fi]) ** 2, axis=-1)
    e_r = (uvr[:, 2] - f_ur[fi]) ** 2
    chi = jnp.where(f_ur[fi] >= 0, (e_uv + e_r) / s2, e_uv / s2)
    chi_th = jnp.where(f_ur[fi] >= 0, 7.8, 5.99)
    return jnp.where((idx >= 0) & (chi <= chi_th), idx, -1)


def _dispatch_fuse_into_kf(
    m: MapState, t: int, cand_ids: np.ndarray, cfg: SlamConfig
):
    """Dispatch (no fetch) the projection-fuse match of candidate map points
    into KF ``t``'s features. Returns (device handle (cap,), cap)."""
    cap = 1 << max(6, int(np.ceil(np.log2(max(len(cand_ids), 1)))))
    pad = lambda a, shape, fill=0: np.concatenate(  # noqa: E731
        [a, np.full((shape - len(a),) + a.shape[1:], fill, a.dtype)]
    )
    idx = _fuse_match_kernel(
        cfg.camera,
        jnp.asarray(m.kf_pose[t]),
        jnp.asarray(pad(m.mp_pos[cand_ids], cap)),
        jnp.asarray(pad(m.mp_desc[cand_ids], cap)),
        jnp.asarray(pad(m.mp_level[cand_ids], cap)),
        jnp.asarray(pad(m.mp_min_dist[cand_ids], cap)),
        jnp.asarray(pad(m.mp_max_dist[cand_ids], cap, 1e9)),
        jnp.asarray(pad(m.mp_normal[cand_ids], cap)),
        jnp.asarray(pad(m.mp_valid[cand_ids], cap)),
        jnp.asarray(m.kf_uv[t]),
        jnp.asarray(m.kf_ur[t]),
        jnp.asarray(m.kf_level[t]),
        jnp.asarray(m.kf_desc[t]),
        jnp.asarray(m.kf_feat_valid[t]),
        cfg.orb.scale,
        cfg.orb.levels,
    )
    return idx, cap


def _fuse_into_kf(m: MapState, t: int, cand_ids: np.ndarray, cfg: SlamConfig):
    """Fuse candidate map points into KF ``t``'s features: replace-or-add
    (ORBmatcher::Fuse apply rule, ORBmatcher.cc:920-941)."""
    handle, _ = _dispatch_fuse_into_kf(m, t, cand_ids, cfg)
    idx = np.asarray(handle)[: len(cand_ids)]
    return _apply_fuse(m, t, cand_ids, idx)


def _apply_fuse(m: MapState, t: int, cand_ids, idx, cand_gen=None):
    """Apply one target's fuse matches: replace-or-add
    (ORBmatcher::Fuse apply rule, ORBmatcher.cc:920-941). ``cand_gen``
    (same shape as cand_ids) guards deferred application: a candidate slot
    culled AND recycled since the match kernel ran holds a different
    landmark and is skipped."""
    n_fused = 0
    for p_slot in np.flatnonzero(idx >= 0):
        p_id = int(cand_ids[p_slot])
        if not m.mp_valid[p_id]:
            continue
        if cand_gen is not None and m.mp_gen[p_id] != cand_gen[p_slot]:
            continue
        f = int(idx[p_slot])
        existing = int(m.kf_feat_mp[t, f])
        if existing == p_id:
            continue
        if existing >= 0 and m.mp_valid[existing]:
            # Keep the better-observed landmark (MapPoint::Replace rule).
            if m.mp_n_obs[existing] > m.mp_n_obs[p_id]:
                m.replace_map_point(p_id, existing)
            else:
                m.replace_map_point(existing, p_id)
        elif p_id in m.kf_feat_mp[t]:
            # Re-check against the CURRENT row: a replace_map_point for an
            # earlier candidate may have rewritten this KF's observations
            # since the match kernel ran; binding p_id to a second feature
            # slot would double-count the (KF, point) pair (ADVICE r4).
            continue
        else:
            m.add_point_obs(t, [f], [p_id])
        n_fused += 1
    return n_fused


def dispatch_fuse(m: MapState, kf: int, cfg: SlamConfig):
    """Dispatch duplicate-landmark fusion with 1-hop + 2-hop covisible
    neighbours (LocalMapping::SearchInNeighbors, LocalMapping.cc:761-891)
    WITHOUT fetching: forward (the new KF's points into each target, one
    vmapped dispatch) and reverse (all target points into the new KF, one
    dispatch). Commit later with commit_fuse. Returns None if nothing to
    fuse."""
    targets: list[int] = []
    for t in m.best_covisible(kf, 10):
        t = int(t)
        if t not in targets:
            targets.append(t)
        for t2 in m.best_covisible(t, 5):
            t2 = int(t2)
            if t2 != kf and t2 not in targets:
                targets.append(t2)
    if not targets:
        return None

    mp_kf = m.kf_feat_mp[kf]
    own = np.unique(mp_kf[mp_kf >= 0])
    own = own[m.mp_valid[own]]

    # Forward: the new KF's points into each target (batched over targets).
    fwd = []
    for t in targets:
        if len(own) == 0:
            break
        # Skip points the target already observes (pMP->IsInKeyFrame(pKF)
        # in ORBmatcher::Fuse): fusing one of those into a second feature
        # slot would double-bind the (KF, point) pair.
        row = m.kf_feat_mp[t]
        own_t = own[~np.isin(own, row[row >= 0])]
        if len(own_t):
            fwd.append((t, own_t))
    fwd_handle = cand_b = None
    if fwd:
        cap = 1 << max(
            6, int(np.ceil(np.log2(max(max(len(c) for _, c in fwd), 1))))
        )
        # Bucket the target axis to a power of two (pad rows match nothing)
        # so the whole run compiles a handful of (B, cap) shapes.
        B = 1 << max(3, int(np.ceil(np.log2(len(fwd)))))
        cand_b = np.zeros((B, cap), np.int64)
        cvalid = np.zeros((B, cap), bool)
        for j, (t, c) in enumerate(fwd):
            cand_b[j, : len(c)] = c
            cvalid[j, : len(c)] = m.mp_valid[c]
        tgt = np.asarray(
            ([t for t, _ in fwd] + [fwd[0][0]] * B)[:B]
        )
        fwd_handle = jax.vmap(
            lambda T, pos, desc, lvl, mind, maxd, nrm, val, fuv, fur,
            flvl, fdesc, fval: _fuse_match_kernel(
                cfg.camera, T, pos, desc, lvl, mind, maxd, nrm, val,
                fuv, fur, flvl, fdesc, fval,
                cfg.orb.scale, cfg.orb.levels,
            )
        )(
            jnp.asarray(m.kf_pose[tgt]),
            jnp.asarray(m.mp_pos[cand_b] * cvalid[..., None]),
            jnp.asarray(m.mp_desc[cand_b] * cvalid[..., None]),
            jnp.asarray(m.mp_level[cand_b] * cvalid),
            jnp.asarray(m.mp_min_dist[cand_b] * cvalid),
            jnp.asarray(
                np.where(cvalid, m.mp_max_dist[cand_b], 1e9)
            ),
            jnp.asarray(m.mp_normal[cand_b] * cvalid[..., None]),
            jnp.asarray(cvalid),
            jnp.asarray(m.kf_uv[tgt]),
            jnp.asarray(m.kf_ur[tgt]),
            jnp.asarray(m.kf_level[tgt]),
            jnp.asarray(m.kf_desc[tgt]),
            jnp.asarray(m.kf_feat_valid[tgt]),
        )

    # Reverse direction: candidates from all targets not yet seen by kf.
    cand = m.kf_feat_mp[np.asarray(targets)].reshape(-1)
    cand = np.unique(cand[cand >= 0])
    cand = cand[m.mp_valid[cand]]
    seen = set(int(i) for i in m.kf_feat_mp[kf] if i >= 0)
    cand = np.asarray([c for c in cand if int(c) not in seen], np.int64)
    rev_handle = None
    if len(cand):
        rev_handle, cap_r = _dispatch_fuse_into_kf(m, kf, cand, cfg)
    if fwd_handle is None and rev_handle is None:
        return None
    return {
        "kf": kf,
        "kf_seq": int(m.kf_seq[kf]),
        "fwd": fwd,
        "fwd_seq": [int(m.kf_seq[t]) for t, _ in fwd],
        "cand_b": cand_b,
        "cand_b_gen": None if cand_b is None else m.mp_gen[cand_b].copy(),
        "fwd_handle": fwd_handle,
        "own": own,
        "rev_cand": cand,
        "rev_gen": m.mp_gen[cand].copy() if len(cand) else None,
        "rev_handle": rev_handle,
    }


def commit_fuse(m: MapState, pend, cfg: SlamConfig) -> int:
    """Fetch + apply a dispatched fuse. Deferred application is guarded by
    KF sequence checks (targets culled meanwhile) and per-candidate slot
    generations (_apply_fuse cand_gen) — see dispatch_fuse."""
    n_fused = 0
    fwd_idx = rev_idx = None
    fetch = [h for h in (pend["fwd_handle"], pend["rev_handle"]) if h is not None]
    got = list(jax.device_get(tuple(fetch)))
    if pend["fwd_handle"] is not None:
        fwd_idx = got.pop(0)
    if pend["rev_handle"] is not None:
        rev_idx = got.pop(0)

    if fwd_idx is not None:
        for j, (t, c) in enumerate(pend["fwd"]):
            if not m.kf_valid[t] or int(m.kf_seq[t]) != pend["fwd_seq"][j]:
                continue
            n_fused += _apply_fuse(
                m, t, pend["cand_b"][j], fwd_idx[j],
                cand_gen=pend["cand_b_gen"][j],
            )
    kf = pend["kf"]
    kf_alive = m.kf_valid[kf] and int(m.kf_seq[kf]) == pend["kf_seq"]
    if rev_idx is not None and kf_alive:
        n = len(pend["rev_cand"])
        n_fused += _apply_fuse(
            m, kf, pend["rev_cand"], rev_idx[:n], cand_gen=pend["rev_gen"]
        )

    if n_fused:
        if kf_alive:
            m._update_covisibility(kf)
        own, cand = pend["own"], pend["rev_cand"]
        touched = np.unique(np.concatenate([own, cand])) if len(cand) else own
        m.update_point_stats(touched)
    return n_fused


def search_in_neighbors(m: MapState, kf: int, cfg: SlamConfig) -> int:
    """Synchronous dispatch+commit wrapper (tests / non-pipelined callers)."""
    pend = dispatch_fuse(m, kf, cfg)
    return 0 if pend is None else commit_fuse(m, pend, cfg)


def cull_keyframes(m: MapState, kf: int, cfg: SlamConfig, protect=()) -> list:
    """KeyFrameCulling (LocalMapping.cc:989-1055): a covisible KF whose close
    map points are >= 90% redundantly observed (>= 3 other KFs at the same or
    finer scale) is removed. Returns the list of KF slots to erase; the
    caller must fix up trajectory references, erase from the BoW DB, and call
    m.erase_keyframe."""
    victims = []
    n = m.n_kf
    protect = set(protect) | {0, kf}
    for k in m.covisible_kfs(kf):
        k = int(k)
        if k in protect:
            continue
        row = m.kf_feat_mp[k]
        feat = np.flatnonzero(row >= 0)
        if len(feat) == 0:
            continue
        depth_k = m.kf_feat_depth[k, feat]
        feat = feat[(depth_k > 0) & (depth_k < cfg.th_depth)]
        ids = row[feat]
        alive = m.mp_valid[ids]
        feat, ids = feat[alive], ids[alive]
        if len(feat) == 0:
            continue
        lvl_req = np.zeros(m.mp_valid.shape[0], np.int32)
        lvl_req[ids] = m.kf_level[k, feat] + 1
        in_sel = np.zeros(m.mp_valid.shape[0], bool)
        in_sel[ids] = True
        obs = m.kf_feat_mp[:n]
        hit = (obs >= 0) & in_sel[np.maximum(obs, 0)] & m.kf_valid[:n, None]
        hit[k] = False
        kk, ff = np.nonzero(hit)
        oid = obs[kk, ff]
        good = m.kf_level[kk, ff] <= lvl_req[oid]
        cnt = np.zeros(m.mp_valid.shape[0], np.int32)
        np.add.at(cnt, oid[good], 1)
        if (cnt[ids] >= 3).sum() > 0.9 * len(feat):
            victims.append(k)
    return victims


def cull_points(map_state: MapState, cfg: SlamConfig):
    """MapPointCulling (LocalMapping.cc:200-235): drop points with a bad
    found/visible ratio or too few observations shortly after creation."""
    mp = map_state.mp_valid
    ratio = map_state.mp_found / np.maximum(map_state.mp_visible, 1)
    # Age in keyframes since creation via the monotonic insertion sequence
    # (the reference's mnCurrentKFid - mnFirstKFid; KF slots are recycled so
    # slot arithmetic would mis-age points born in recycled low slots).
    age = map_state.next_kf_seq - 1 - map_state.mp_first_seq
    bad = mp & (
        ((ratio < 0.25) & (map_state.mp_visible >= 4))
        | ((age >= 2) & (map_state.mp_n_obs <= 1) & (map_state.mp_first_seq > 0))
    )
    ids = np.flatnonzero(bad)
    if len(ids):
        map_state.cull_map_points(ids)
    return len(ids)
