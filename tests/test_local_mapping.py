"""Backend (LocalMapping) unit tests: epipolar triangulation, neighbour
fuse, keyframe culling, MapPoint stat refresh, KF slot recycling.

Behavioral spec: reference src/LocalMapping.cc:275-520 (CreateNewMapPoints),
761-891 (SearchInNeighbors), 989-1055 (KeyFrameCulling); src/MapPoint.cc
(ComputeDistinctiveDescriptors / UpdateNormalAndDepth / Replace).
"""

import numpy as np
import pytest

from pslam.models.map_state import MapState
from pslam.pipeline import line_mapping, local_mapping
from pslam.utils.config import SlamConfig

CFG = SlamConfig(use_lines=False, use_bow=False, use_loop_closing=False)
RNG = np.random.default_rng(7)


def look_at_pose(C, yaw=0.0):
    """T_cw with camera center C, z forward (+ small yaw)."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    R_wc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R_wc.T
    T[:3, 3] = -R_wc.T @ np.asarray(C, np.float32)
    return T


def project(cam, T_cw, X_w):
    Xc = X_w @ T_cw[:3, :3].T + T_cw[:3, 3]
    z = Xc[:, 2]
    u = cam.fx * Xc[:, 0] / z + cam.cx
    v = cam.fy * Xc[:, 1] / z + cam.cy
    return np.stack([u, v], -1).astype(np.float32), z.astype(np.float32)


def add_kf_observing(m, X_w, descs, T_cw, frame_id, with_depth=True,
                     feat_mp=None, level=None):
    """Insert a KF whose first len(X_w) feature slots observe X_w."""
    cam = CFG.camera
    N = CFG.orb.capacity
    uv, z = project(cam, T_cw, X_w)
    n = len(X_w)
    uv_a = np.zeros((N, 2), np.float32)
    uv_a[:n] = uv
    depth = np.zeros(N, np.float32)
    ur = np.full(N, -1.0, np.float32)
    if with_depth:
        depth[:n] = z
        ur[:n] = uv[:, 0] - cam.bf / z
    lvl = np.zeros(N, np.int32)
    if level is not None:
        lvl[:n] = level
    desc = np.zeros((N, 32), np.uint8)
    desc[:n] = descs
    valid = np.zeros(N, bool)
    valid[:n] = True
    fmp = np.full(N, -1, np.int32)
    if feat_mp is not None:
        fmp[:n] = feat_mp
    return m.add_keyframe(
        frame_id, float(frame_id), T_cw, uv_a, ur, lvl,
        np.zeros(N, np.float32), desc, valid, depth, fmp,
    )


@pytest.fixture()
def scene():
    X_w = np.concatenate(
        [RNG.uniform([-1.5, -1.0, 3.0], [1.5, 1.0, 5.0], (60, 3))]
    ).astype(np.float32)
    descs = RNG.integers(0, 256, (60, 32), dtype=np.uint8)
    return X_w, descs


def test_epipolar_triangulation_creates_points(scene):
    X_w, descs = scene
    m = MapState(CFG)
    T0 = look_at_pose([0, 0, 0])
    T1 = look_at_pose([0.25, 0, 0], yaw=0.02)
    k0 = add_kf_observing(m, X_w, descs, T0, 0, with_depth=False)
    k1 = add_kf_observing(m, X_w, descs, T1, 1, with_depth=False)
    # Manufacture covisibility so k1 is a neighbour of k0: give both a few
    # shared dummy map points.
    shared = m.alloc_map_points(20)
    m.mp_valid[shared] = True
    m.kf_feat_mp[k0, 100 : 100 + 20] = shared
    m.kf_feat_mp[k1, 100 : 100 + 20] = shared
    m._attach_observations(k0)
    m._update_covisibility(k1)

    n = local_mapping.create_new_map_points(m, k1, CFG)
    assert n >= 45, f"triangulated only {n}/60"
    # Created points match ground truth.
    ids = np.flatnonzero(m.mp_valid)
    ids = ids[~np.isin(ids, shared)]
    err = []
    for i in ids:
        d = np.linalg.norm(X_w - m.mp_pos[i], axis=1).min()
        err.append(d)
    assert np.median(err) < 0.02
    # Observations attached in both views.
    assert (m.kf_feat_mp[k0, :60] >= 0).sum() >= 40
    assert (m.kf_feat_mp[k1, :60] >= 0).sum() >= 40
    assert (m.mp_n_obs[ids] == 2).all()


def test_fuse_merges_duplicates(scene):
    X_w, descs = scene
    m = MapState(CFG)
    T0 = look_at_pose([0, 0, 0])
    T1 = look_at_pose([0.3, 0, 0], yaw=0.03)
    k0 = add_kf_observing(m, X_w, descs, T0, 0)
    k1 = add_kf_observing(m, X_w, descs, T1, 1)
    # Each KF minted its own duplicate landmark for the same physical point.
    ids0 = m.create_points_from_depth(k0, np.arange(60), X_w)
    ids1 = m.create_points_from_depth(
        k1, np.arange(60), X_w + RNG.normal(0, 0.003, X_w.shape).astype(np.float32)
    )
    # Give k0's copies an extra fake observation so they win replacements.
    m.mp_n_obs[ids0] += 1
    m._update_covisibility(k1)
    n_before = int(m.mp_valid.sum())
    assert n_before == 120

    # No covisibility edge yet (no shared points) -> force neighbourhood.
    m.covis[k0, k1] = m.covis[k1, k0] = 60
    fused = local_mapping.search_in_neighbors(m, k1, CFG)
    assert fused >= 40, f"fused only {fused}"
    n_after = int(m.mp_valid.sum())
    assert n_after <= n_before - 40
    # k1 now observes k0's surviving landmarks.
    both = np.isin(m.kf_feat_mp[k1, :60], ids0)
    assert both.sum() >= 40


def test_keyframe_culling_and_slot_recycling(scene):
    _, descs = scene
    # Culling only counts CLOSE points (depth < ThDepth ~ 3.1 m for the
    # default camera; LocalMapping.cc:1007).
    X_w = RNG.uniform([-0.8, -0.6, 1.5], [0.8, 0.6, 2.8], (60, 3)).astype(
        np.float32
    )
    m = MapState(CFG)
    kfs = []
    for i, dx in enumerate([0.0, 0.05, 0.10, 0.15]):
        T = look_at_pose([dx, 0, 0])
        k = add_kf_observing(m, X_w, descs, T, i)
        if i == 0:
            ids = m.create_points_from_depth(k, np.arange(60), X_w)
        else:
            m.add_point_obs(k, np.arange(60), ids)
            m._update_covisibility(k)
        kfs.append(k)
    # Every point is seen by 4 KFs at level 0 -> middle KFs are redundant.
    victims = local_mapping.cull_keyframes(m, kfs[-1], CFG, protect={kfs[-1]})
    assert set(victims) == {kfs[1], kfs[2]}
    for k in victims:
        m.erase_keyframe(k)
    assert not m.kf_valid[victims].any()
    assert (m.mp_n_obs[ids] == 2).all()

    # The freed slots are recycled before the high-water mark moves.
    k_new = add_kf_observing(m, X_w, descs, look_at_pose([0.2, 0, 0]), 99)
    assert k_new in victims
    assert m.n_kf == 4


def test_update_point_stats_distinctive_descriptor():
    m = MapState(CFG)
    X = np.array([[0.0, 0.0, 4.0]], np.float32)
    # Three observers with descriptors where d1 is the medoid.
    d0 = np.zeros((1, 32), np.uint8)
    d1 = d0.copy(); d1[0, 0] = 0x0F          # 4 bits from d0
    d2 = d0.copy(); d2[0, 0] = 0xFF; d2[0, 1] = 0xFF  # 16 bits from d0
    ks = []
    for i, (dx, dd) in enumerate(zip([0.0, 0.4, -0.4], [d0, d1, d2])):
        T = look_at_pose([dx, 0, 0])
        k = add_kf_observing(m, X, dd, T, i)
        ks.append(k)
    ids = m.create_points_from_depth(ks[0], np.array([0]), X)
    m.add_point_obs(ks[1], np.array([0]), ids)
    m.add_point_obs(ks[2], np.array([0]), ids)
    m.update_point_stats(ids)
    # Median Hamming: d0 -> {4, 16} med 16@idx1? sorted [0,4,16] med 4;
    # d1 -> [0,4,12] med 4; d2 -> [0,12,16] med 12. Tie d0/d1 broken by
    # argmin order (d0). Distinctive descriptor must NOT be the outlier d2.
    assert not np.array_equal(m.mp_desc[ids[0]], d2[0])
    # Normal is the mean viewing direction, roughly +z.
    n = m.mp_normal[ids[0]]
    assert n[2] > 0.9


def test_create_new_map_lines_two_view():
    """CreateNewMapLines2 RGB-D analogue: a depth-fitted 3D line on the new
    KF that reprojects onto a matching 2D line in a neighbour becomes a map
    line observed by both (LocalMapping.cc:522-759)."""
    cfg = SlamConfig(use_bow=False, use_loop_closing=False)
    m = MapState(cfg)
    cam = cfg.camera
    # World segments on a fronto-parallel plane at z=3.
    segs = np.array(
        [[-1.0, -0.5, 3.0, 1.0, -0.5, 3.0],
         [-1.0, 0.4, 3.0, 0.8, 0.6, 3.0],
         [0.2, -0.8, 3.2, 0.2, 0.8, 3.2]],
        np.float32,
    )
    descs = RNG.normal(0, 1, (3, 40)).astype(np.float32)
    T0 = look_at_pose([0, 0, 0])
    T1 = look_at_pose([0.3, 0.0, 0.0], yaw=0.03)

    NL = cfg.lines.n_lines
    ks = []
    pts_desc = RNG.integers(0, 256, (40, 32), dtype=np.uint8)
    X_pts = RNG.uniform([-1, -1, 2.5], [1, 1, 4.0], (40, 3)).astype(np.float32)
    for i, T in enumerate([T0, T1]):
        k = add_kf_observing(m, X_pts, pts_desc, T, i)
        sp_c = segs[:, :3] @ T[:3, :3].T + T[:3, 3]
        ep_c = segs[:, 3:] @ T[:3, :3].T + T[:3, 3]

        def proj(X):
            return np.stack(
                [cam.fx * X[:, 0] / X[:, 2] + cam.cx,
                 cam.fy * X[:, 1] / X[:, 2] + cam.cy], -1
            ).astype(np.float32)

        m.kf_line_sp[k, :3] = proj(sp_c)
        m.kf_line_ep[k, :3] = proj(ep_c)
        m.kf_line_desc[k, :3] = descs
        m.kf_line_valid[k, :3] = True
        m.kf_line_p3s[k, :3] = sp_c
        m.kf_line_p3e[k, :3] = ep_c
        m.kf_line_ok3d[k, :3] = True
        ks.append(k)
    ids = m.create_points_from_depth(ks[0], np.arange(40), X_pts)
    m.add_point_obs(ks[1], np.arange(40), ids)
    m._update_covisibility(ks[1])

    n = line_mapping.create_new_map_lines(m, ks[1], cfg)
    assert n == 3
    assert (m.kf_line_ml[ks[0], :3] >= 0).all()
    assert (m.kf_line_ml[ks[1], :3] >= 0).all()
    created = m.kf_line_ml[ks[1], :3]
    assert (m.ml_n_obs[created] == 2).all()
    # Endpoints in world frame match (up to endpoint swap/extension).
    for i, mid in enumerate(created):
        mid_pt = 0.5 * (m.ml_pos[mid, :3] + m.ml_pos[mid, 3:])
        gt_mid = 0.5 * (segs[i, :3] + segs[i, 3:])
        assert np.linalg.norm(mid_pt - gt_mid) < 0.05


def test_capacity_survives_many_keyframes(scene):
    """>capacity KF insertions survive when interleaved with culling
    (VERDICT round 1, item 5)."""
    _, descs = scene
    X_w = RNG.uniform([-0.8, -0.6, 1.5], [0.8, 0.6, 2.8], (60, 3)).astype(
        np.float32
    )
    m = MapState(CFG)
    K = CFG.caps.max_keyframes
    k0 = add_kf_observing(m, X_w, descs, look_at_pose([0, 0, 0]), 0)
    ids = m.create_points_from_depth(k0, np.arange(60), X_w)
    n_insert = K + 40
    for i in range(1, n_insert):
        T = look_at_pose([0.01 * (i % 7), 0, 0])
        k = add_kf_observing(m, X_w, descs, T, i)
        m.add_point_obs(k, np.arange(60), ids)
        m._update_covisibility(k)
        if m.n_kf > K - 4:
            victims = local_mapping.cull_keyframes(m, k, CFG, protect={k})
            for v in victims[: max(8, len(victims))]:
                m.erase_keyframe(v)
    assert m.kf_valid.sum() <= K


def _line_scene(cfg, m, segs, descs, poses, bind=()):
    """Insert one KF per pose observing ``segs`` as 2D+3D line features.
    ``bind``: set of (kf_order_idx,) whose lines get pre-bound map lines."""
    cam = cfg.camera
    ks = []
    pts_desc = RNG.integers(0, 256, (40, 32), dtype=np.uint8)
    X_pts = RNG.uniform([-1, -1, 2.5], [1, 1, 4.0], (40, 3)).astype(np.float32)
    n = len(segs)
    for i, T in enumerate(poses):
        k = add_kf_observing(m, X_pts, pts_desc, T, i)
        sp_c = segs[:, :3] @ T[:3, :3].T + T[:3, 3]
        ep_c = segs[:, 3:] @ T[:3, :3].T + T[:3, 3]

        def proj(X):
            return np.stack(
                [cam.fx * X[:, 0] / X[:, 2] + cam.cx,
                 cam.fy * X[:, 1] / X[:, 2] + cam.cy], -1
            ).astype(np.float32)

        m.kf_line_sp[k, :n] = proj(sp_c)
        m.kf_line_ep[k, :n] = proj(ep_c)
        m.kf_line_desc[k, :n] = descs
        m.kf_line_valid[k, :n] = True
        m.kf_line_p3s[k, :n] = sp_c
        m.kf_line_p3e[k, :n] = ep_c
        m.kf_line_ok3d[k, :n] = True
        ks.append(k)
    # Shared points for covisibility.
    ids = m.create_points_from_depth(ks[0], np.arange(40), X_pts)
    for k in ks[1:]:
        m.add_point_obs(k, np.arange(40), ids)
        m._update_covisibility(k)
    return ks


def test_fuse_lines_in_neighbors_merges_duplicates():
    """LSDmatcher::Fuse analogue (add_src/LSDmatcher.cpp:847): two KFs that
    independently minted map lines for the same physical segment get merged
    into one landmark with both observations."""
    cfg = SlamConfig(use_bow=False, use_loop_closing=False)
    m = MapState(cfg)
    segs = np.array(
        [[-1.0, -0.5, 3.0, 1.0, -0.5, 3.0],
         [-1.0, 0.4, 3.0, 0.8, 0.6, 3.0]],
        np.float32,
    )
    descs = RNG.normal(0, 1, (2, 40)).astype(np.float32)
    T0 = look_at_pose([0, 0, 0])
    T1 = look_at_pose([0.3, 0.0, 0.0], yaw=0.03)
    ks = _line_scene(cfg, m, segs, descs, [T0, T1])

    # Each KF mints its OWN map lines (duplicates of the same world segs).
    pos_w = segs.copy()
    a = m.create_map_lines(ks[0], np.arange(2), pos_w, descs)
    b = m.create_map_lines(ks[1], np.arange(2), pos_w + 0.01, descs)
    assert (a != b).all()

    n = line_mapping.fuse_lines_in_neighbors(m, ks[1], cfg)
    assert n >= 2
    # One landmark per segment survives, observed by both KFs.
    ml0 = m.kf_line_ml[ks[0], :2]
    ml1 = m.kf_line_ml[ks[1], :2]
    assert (ml0 == ml1).all()
    assert (m.ml_n_obs[ml0] >= 2).all()
    # The losing duplicates are dead.
    dead = np.setdiff1d(np.concatenate([a, b]), ml0)
    assert not m.ml_valid[dead].any()


def test_replace_map_line_erases_duplicate_observation():
    cfg = SlamConfig(use_bow=False, use_loop_closing=False)
    m = MapState(cfg)
    descs = RNG.integers(0, 256, (10, 32), dtype=np.uint8)
    X = RNG.uniform([-1, -1, 2], [1, 1, 4], (10, 3)).astype(np.float32)
    k0 = add_kf_observing(m, X, descs, look_at_pose([0, 0, 0]), 0)
    k1 = add_kf_observing(m, X, descs, look_at_pose([0.2, 0, 0]), 1)
    d = RNG.normal(0, 1, (2, 40)).astype(np.float32)
    (old,) = m.create_map_lines(
        k0, np.array([0]), np.zeros((1, 6), np.float32), d[:1]
    )
    (new,) = m.create_map_lines(
        k1, np.array([1]), np.zeros((1, 6), np.float32), d[1:]
    )
    # k1 observes BOTH old and new -> after replace, the duplicate slot
    # must be cleared, not rebound; k0 (which sees only old) rebinds.
    m.kf_line_ml[k1, 0] = old
    m.ml_n_obs[[old, new]] = [2, 2]
    m.replace_map_line(old, new)
    assert not m.ml_valid[old]
    assert m.kf_line_ml[k1, 0] == -1  # duplicate erased
    assert m.kf_line_ml[k1, 1] == new
    assert m.kf_line_ml[k0, 0] == new  # k0 rebound


def test_update_line_stats_refreshes_descriptor_and_band():
    """MapLine::ComputeDistinctiveDescriptors + UpdateAverageDir parity
    (add_src/MapLine.cpp:241, 320): ml_desc converges to the central
    observation descriptor; the distance band spans the observers."""
    cfg = SlamConfig(use_bow=False, use_loop_closing=False)
    m = MapState(cfg)
    seg = np.array([[-1.0, 0.0, 3.0, 1.0, 0.0, 3.0]], np.float32)
    base = RNG.normal(0, 1, 40).astype(np.float32)
    poses = [look_at_pose([0, 0, 0]), look_at_pose([0.2, 0, 0]),
             look_at_pose([0, 0, 1.0])]
    descs = base[None, :]
    ks = _line_scene(cfg, m, seg, descs, poses)
    # Slightly different descriptor per observation; the middle one (closest
    # to the others) must win.
    m.kf_line_desc[ks[0], 0] = base + 0.9  # outlier observation
    m.kf_line_desc[ks[1], 0] = base
    m.kf_line_desc[ks[2], 0] = base + 0.05
    ids = m.create_map_lines(ks[0], np.array([0]), seg, descs)
    m.kf_line_ml[ks[1], 0] = ids[0]
    m.kf_line_ml[ks[2], 0] = ids[0]
    m.ml_n_obs[ids[0]] = 3

    m.update_line_stats(ids)
    assert np.allclose(m.ml_desc[ids[0]], base)
    # Band: z=3 plane seen from z=0 and z=1 -> min ~2, max ~3.
    assert m.ml_min_dist[ids[0]] < 2.3
    assert m.ml_max_dist[ids[0]] > 2.9
    # Normal points from cameras toward the line (world +z).
    assert m.ml_normal[ids[0], 2] > 0.9


def test_alloc_evicts_instead_of_raising():
    """Capacity exhaustion degrades gracefully: the lowest-value landmarks
    are evicted rather than raising (VERDICT r2 weak #9)."""
    m = MapState(CFG)
    P = m.mp_valid.shape[0]
    a = m.alloc_map_points(P)  # fill completely
    m.mp_valid[a] = True
    m.mp_n_obs[a] = 5
    m.mp_n_obs[a[:7]] = 1  # weakest
    ids = m.alloc_map_points(4)
    assert len(ids) == 4
    assert set(ids).issubset(set(a[:7]))  # recycled the weakest slots
    assert m.mp_valid.sum() == P - 4  # exactly the shortfall evicted
