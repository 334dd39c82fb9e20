"""Checkpoint/resume of the full system state (SURVEY §5: the reference's
SaveMap/LoadMap are TODO stubs, System.h:117-119 — implemented here)."""

import numpy as np
import pytest

from pslam.io.checkpoint import load_checkpoint, save_checkpoint
from pslam.io.synthetic import render_sequence
from pslam.ops.orb import OrbConfig
from pslam.pipeline.system import SlamSystem, TrackState
from pslam.utils.config import Capacities, SlamConfig


def _cfg():
    return SlamConfig(
        orb=OrbConfig(n_features=256),
        caps=Capacities(max_keyframes=32, max_map_points=8192,
                        local_points=1024),
        use_lines=False,
        use_loop_closing=True,
        bow_k=8,
        bow_levels=3,
    )


@pytest.fixture(scope="module")
def tracked_system():
    cfg = _cfg()
    slam = SlamSystem(cfg)
    grays, depths, _ = render_sequence(cfg.camera, n_frames=5, seed=1)
    for i, (g, d) in enumerate(zip(grays, depths)):
        slam.track_rgbd(g, d, 100.0 + i / 30.0)
    assert slam.state == TrackState.OK
    assert slam.map.n_kf >= 1
    return cfg, slam


def test_roundtrip_identical(tracked_system, tmp_path):
    cfg, slam = tracked_system
    p = str(tmp_path / "ckpt.npz")
    save_checkpoint(slam, p)
    slam2 = load_checkpoint(p, cfg)

    m1, m2 = slam.map, slam2.map
    assert m2.n_kf == m1.n_kf
    np.testing.assert_array_equal(m2.kf_pose, m1.kf_pose)
    np.testing.assert_array_equal(m2.kf_desc, m1.kf_desc)
    np.testing.assert_array_equal(m2.kf_feat_mp, m1.kf_feat_mp)
    np.testing.assert_array_equal(m2.mp_valid, m1.mp_valid)
    np.testing.assert_array_equal(m2.mp_pos, m1.mp_pos)
    np.testing.assert_array_equal(m2.covis, m1.covis)
    assert m2._mp_free_head == m1._mp_free_head

    # Trajectory reproduces bit-exactly (chained against restored KF poses).
    np.testing.assert_array_equal(slam2.poses, slam.poses)
    assert slam2.frame_id == slam.frame_id
    assert slam2.ref_kf == slam.ref_kf

    # BoW DB restored.
    np.testing.assert_array_equal(slam2.kf_db.bow, slam.kf_db.bow)
    np.testing.assert_array_equal(slam2.kf_db.present, slam.kf_db.present)
    for a, b in zip(slam2.kf_db.vocab.node_desc, slam.kf_db.vocab.node_desc):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_resume_tracks_on(tracked_system, tmp_path):
    """A resumed session relocalizes against the restored map and keeps
    tracking (no motion-model state survives the checkpoint)."""
    cfg, slam = tracked_system
    p = str(tmp_path / "ckpt2.npz")
    save_checkpoint(slam, p)
    slam2 = load_checkpoint(p, cfg)
    assert slam2.state == TrackState.LOST

    grays, depths, _ = render_sequence(cfg.camera, n_frames=5, seed=1)
    n_traj = len(slam2.trajectory)
    slam2.track_rgbd(grays[4], depths[4], 101.0)
    assert len(slam2.trajectory) == n_traj + 1
    # Either relocalized (OK) or still LOST-but-alive; with an identical
    # revisited view relocalization must succeed.
    assert slam2.state == TrackState.OK


def test_capacity_mismatch_rejected(tracked_system, tmp_path):
    cfg, slam = tracked_system
    p = str(tmp_path / "ckpt3.npz")
    save_checkpoint(slam, p)
    import dataclasses

    bad = dataclasses.replace(cfg, caps=Capacities(max_keyframes=8))
    with pytest.raises(ValueError, match="capacity"):
        load_checkpoint(p, bad)
