"""Loop closing end-to-end on a hand-built drifted map (LoopClosing.cc
behavior, enabled per BASELINE config 4).

Scenario: an out-and-back trajectory over three landmark clouds A, B, C.
The revisit keyframes re-observe cloud A's world geometry but — as in a real
drifted SLAM run — hold DUPLICATE map points whose positions (and the revisit
poses) are corrupted by a rigid world-frame drift W. Loop closing must:
detect the revisit via BoW consistency groups, solve the relative Sim3,
correct the revisit poses, fuse the duplicates, and pull the trajectory back
onto the pre-drift frame via the essential graph.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from pslam.geometry import se3_exp
from pslam.geometry.camera import project
from pslam.pipeline.system import SlamSystem
from pslam.utils.config import Capacities, SlamConfig
from pslam.ops.orb import OrbConfig


def _make_cfg():
    return SlamConfig(
        orb=OrbConfig(n_features=256),
        caps=Capacities(
            max_keyframes=32, max_map_points=4096, local_points=512,
            gba_cams=32, gba_free=16, gba_points=1024, gba_edges=4096,
        ),
        use_lines=False,
        bow_k=8,
        bow_levels=3,
    )


@pytest.fixture(scope="module")
def drifted_world():
    cfg = _make_cfg()
    slam = SlamSystem(cfg)
    m = slam.map
    rng = np.random.default_rng(0)
    cam = cfg.camera
    N = cfg.orb.capacity
    P_CLOUD = 150

    # Three clouds along a corridor (world frame), each visible from its
    # segment of the trajectory.
    clouds = []
    for ci in range(3):
        c = rng.uniform(
            [-1.5, -1.0, 2.0 + 2.5 * ci], [1.5, 1.0, 4.0 + 2.5 * ci],
            (P_CLOUD, 3),
        ).astype(np.float32)
        clouds.append(c)
    descs = [
        rng.integers(0, 256, (P_CLOUD, 32), dtype=np.uint8) for _ in range(3)
    ]

    # Trajectory: KFs 0-2 see A, 3-5 see B, 6-8 see C, 9-13 see A again.
    segments = [0, 0, 0, 1, 1, 1, 2, 2, 2, 0, 0, 0, 0, 0]
    K = len(segments)
    poses_true = []
    for k in range(K):
        ci = segments[k]
        base_z = 2.5 * ci
        off = rng.normal(0, 0.08, 3).astype(np.float32)
        xi = np.r_[
            rng.normal(0, 0.02, 3),
            [0.15 * (k % 3) + off[0], off[1], base_z * 0.0 + off[2]],
        ].astype(np.float32)
        # Camera at z ~ 0 looking down +z; shift along z per segment so the
        # segment's cloud is in front.
        T = np.array(se3_exp(jnp.asarray(xi)))
        T[2, 3] -= base_z  # move camera forward to z = base_z (t = -R C)
        poses_true.append(T.astype(np.float32))

    # Rigid drift applied to the revisit section (KFs 9+): world' = W(world).
    xi_w = np.array([0.02, -0.03, 0.025, 0.25, -0.18, 0.22], np.float32)
    W = np.array(se3_exp(jnp.asarray(xi_w)))
    W_inv = np.linalg.inv(W)

    cloud_ids = {}  # (segment, first-visit?) -> map point ids
    for k in range(K):
        ci = segments[k]
        revisit = k >= 9
        X_w = clouds[ci]
        if revisit:
            X_w = (X_w @ W[:3, :3].T) + W[:3, 3]  # drifted duplicates
            T_cw = (poses_true[k] @ W_inv).astype(np.float32)
        else:
            T_cw = poses_true[k]
        Xc = X_w @ T_cw[:3, :3].T + T_cw[:3, 3]
        uv = np.asarray(project(cam, jnp.asarray(Xc))).astype(np.float32)
        z = Xc[:, 2]
        ok = (
            (z > 0.1) & (uv[:, 0] >= 0) & (uv[:, 0] < cam.width)
            & (uv[:, 1] >= 0) & (uv[:, 1] < cam.height)
        )

        uv_f = np.zeros((N, 2), np.float32)
        ur_f = np.full(N, -1.0, np.float32)
        depth_f = np.zeros(N, np.float32)
        desc_f = np.zeros((N, 32), np.uint8)
        valid_f = np.zeros(N, bool)
        nsel = min(ok.sum(), N)
        sel = np.flatnonzero(ok)[:nsel]
        uv_f[:nsel] = uv[sel]
        depth_f[:nsel] = z[sel]
        ur_f[:nsel] = uv[sel, 0] - cam.bf / z[sel]
        desc_f[:nsel] = descs[ci][sel]
        valid_f[:nsel] = True

        key = (ci, revisit)
        feat_mp = np.full(N, -1, np.int32)
        kf = m.add_keyframe(
            k, float(k), T_cw, uv_f, ur_f, np.zeros(N, np.int32),
            np.zeros(N, np.float32), desc_f, valid_f, depth_f, feat_mp,
        )
        if key not in cloud_ids:
            ids = m.create_points_from_depth(
                kf, np.arange(nsel),
                X_w[sel].astype(np.float32),
            )
            # Store full-cloud id table (-1 where never observed).
            table = np.full(P_CLOUD, -1, np.int32)
            table[sel] = ids
            cloud_ids[key] = table
        else:
            table = cloud_ids[key]
            have = table[sel] >= 0
            m.kf_feat_mp[kf, np.arange(nsel)[have]] = table[sel][have]
            np.add.at(m.mp_n_obs, table[sel][have], 1)
            m._update_covisibility(kf)

        b, w, nd = slam.kf_db.compute_bow(desc_f, valid_f)
        slam.kf_db.add(kf, b, w, nd)

    return cfg, slam, poses_true, W, segments


def test_loop_detected_and_corrected(drifted_world):
    cfg, slam, poses_true, W, segments = drifted_world
    lc = slam.loop_closer
    m = slam.map

    pose_err_before = np.abs(m.kf_pose[12] - poses_true[12]).max()
    assert pose_err_before > 0.05, "test setup: drift should be visible"

    closed = False
    for kf in (9, 10, 11, 12, 13):
        if lc.on_new_keyframe(kf):
            closed = True
            closed_at = kf
            break
    assert closed, "loop was never closed"
    assert lc.stats["closed"] == 1

    # The closing KF's pose must be back near its true (pre-drift) value.
    err = np.abs(m.kf_pose[closed_at] - poses_true[closed_at]).max()
    assert err < 0.03, err

    # Duplicated revisit landmarks must have been pulled onto the original
    # cloud A geometry (warped by ~W before, ~identity after).
    # Check through the closing KF's observations of cloud A.
    mp = m.kf_feat_mp[closed_at]
    ids = mp[mp >= 0]
    pos = m.mp_pos[ids]
    # All of cloud A's original points live at ids from the first visit.
    # After correction both copies should lie in the same (original) frame:
    # distances to the original cloud should be small.
    orig = m.mp_pos[m.mp_valid & (m.mp_first_kf == 0)]
    from scipy.spatial import cKDTree  # noqa: F401  (fallback below if absent)

    d = np.linalg.norm(pos[:, None, :] - orig[None, :, :], axis=-1).min(axis=1)
    assert np.median(d) < 0.05, np.median(d)


def test_no_loop_on_distinct_views(drifted_world):
    """KFs in the middle segment must not trigger loop closure."""
    cfg, slam, *_ = drifted_world
    from pslam.pipeline.loop_closing import LoopCloser

    lc2 = LoopCloser(slam)
    assert lc2.detect_loop(4) == [] or lc2.compute_sim3(4, lc2.detect_loop(4)) is None
