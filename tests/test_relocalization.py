"""Relocalization after tracking loss (Tracking.cc:2031-2180 behavior)."""

import dataclasses

import numpy as np
import pytest

from pslam.io.synthetic import render_sequence
from pslam.pipeline.system import SlamSystem, TrackState
from pslam.utils.config import SlamConfig


@pytest.fixture(scope="module")
def setup():
    cfg = SlamConfig(use_lines=False)
    grays, depths, poses_gt = render_sequence(cfg.camera, n_frames=10, seed=0)
    return cfg, grays, depths, poses_gt


def test_relocalize_after_kidnap(setup):
    cfg, grays, depths, poses_gt = setup
    cfg = dataclasses.replace(
        cfg,
        tracking=dataclasses.replace(
            cfg.tracking,
            reset_if_lost_with_kfs=0,  # force the reloc path, not reset
            kf_max_interval=3,  # densify KFs so the DB has entries
        ),
    )
    slam = SlamSystem(cfg)
    for i in range(len(grays)):
        slam.track_rgbd(grays[i], depths[i], i / 30.0)
    assert slam.state == TrackState.OK
    assert slam.map.n_kf >= 3

    # Kidnap: declare the tracker lost, then show it an already-mapped view.
    slam.state = TrackState.LOST
    T = slam.track_rgbd(grays[3], depths[3], 11 / 30.0)
    assert slam.state == TrackState.OK, "relocalization failed"
    assert slam.stats.get("relocs", 0) == 1
    C_est = -T[:3, :3].T @ T[:3, 3]
    Tg = poses_gt[3]
    C_gt = -Tg[:3, :3].T @ Tg[:3, 3]
    assert np.linalg.norm(C_est - C_gt) < 0.05

    # And tracking continues normally afterwards.
    slam.track_rgbd(grays[4], depths[4], 12 / 30.0)
    assert slam.state == TrackState.OK


def test_reset_when_lost_early(setup):
    cfg, grays, depths, _ = setup
    slam = SlamSystem(cfg)
    slam.track_rgbd(grays[0], depths[0], 0.0)
    assert slam.state == TrackState.OK
    slam.state = TrackState.LOST  # lost with <= 5 KFs -> hard reset
    slam.track_rgbd(grays[5], depths[5], 1 / 30.0)
    assert slam.stats.get("resets", 0) == 1
    assert slam.state == TrackState.OK  # re-initialized on the same frame
    assert slam.map.n_kf == 1
