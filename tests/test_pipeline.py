"""End-to-end integration test: full RGB-D SLAM slice on a synthetic scene
with exact ground truth (SURVEY.md §4 / BASELINE config 1 analogue)."""

import numpy as np
import pytest

from pslam.io.synthetic import render_sequence
from pslam.pipeline.system import SlamSystem, TrackState
from pslam.utils.config import SlamConfig
from pslam.utils.metrics import ate_rmse, trajectory_positions


@pytest.fixture(scope="module")
def sequence():
    cfg = SlamConfig()
    grays, depths, poses_gt = render_sequence(cfg.camera, n_frames=15, seed=0)
    return cfg, grays, depths, poses_gt


@pytest.fixture(scope="module")
def tracked(sequence):
    cfg, grays, depths, poses_gt = sequence
    slam = SlamSystem(cfg)
    for i in range(len(grays)):
        slam.track_rgbd(grays[i], depths[i], i / 30.0)
    return slam, poses_gt


class TestEndToEnd:
    def test_tracks_whole_sequence(self, tracked):
        slam, _ = tracked
        assert slam.state == TrackState.OK
        assert slam.map.n_kf >= 2
        assert int(slam.map.mp_valid.sum()) > 500

    def test_ate_under_threshold(self, tracked):
        slam, poses_gt = tracked
        est = trajectory_positions(slam.poses)
        gt = trajectory_positions(poses_gt)
        ate = ate_rmse(est, gt)
        # Synthetic scene, exact depth: a healthy tracker stays well under
        # 5 cm (reference-class accuracy on fr1-like motion is 1-2 cm).
        assert ate < 0.05, f"ATE {ate:.4f} m"

    def test_local_ba_ran(self, tracked):
        slam, _ = tracked
        assert slam.stats["ba_runs"] >= 1

    def test_trajectory_tum_format(self, tracked, tmp_path):
        slam, _ = tracked
        path = tmp_path / "traj.txt"
        slam.save_trajectory_tum(str(path))
        lines = path.read_text().strip().splitlines()
        assert len(lines) == len(slam.trajectory)
        row = np.asarray(lines[0].split(), np.float64)
        assert row.shape == (8,)  # ts x y z qx qy qz qw
        q = row[4:]
        assert abs(np.linalg.norm(q) - 1.0) < 1e-3


def test_tracking_recovers_pose_each_frame(sequence):
    """Per-frame pose error (not just aligned ATE) stays bounded."""
    cfg, grays, depths, poses_gt = sequence
    slam = SlamSystem(cfg)
    errs = []
    for i in range(len(grays)):
        T = slam.track_rgbd(grays[i], depths[i], i / 30.0)
        C_est = -T[:3, :3].T @ T[:3, 3]
        Tg = poses_gt[i]
        C_gt = -Tg[:3, :3].T @ Tg[:3, 3]
        errs.append(np.linalg.norm(C_est - C_gt))
    # World frame anchored at frame 0 -> absolute comparison is meaningful.
    assert max(errs) < 0.08, errs


class TestStructuralLines:
    def test_lils_created_and_observed(self, tracked):
        """The structural-line path must actually engage on the box scene
        (checker texture yields crossing coplanar lines on every wall)."""
        slam, _ = tracked
        m = slam.map
        assert int(m.ml_valid.sum()) > 0, "no map lines created"
        assert int(m.il_valid.sum()) > 0, "no InsectLine landmarks created"
        # At least one LIL should be re-observed by a later keyframe
        # (plane association) once the map has a few keyframes.
        if m.n_kf >= 3:
            assert int((m.il_n_obs[m.il_valid] >= 2).sum()) >= 1

    def test_point_only_mode_matches_config1(self, sequence):
        """BASELINE config 1: use_lines=False runs the pure point slice."""
        import dataclasses

        cfg, grays, depths, poses_gt = sequence
        cfg1 = dataclasses.replace(cfg, use_lines=False)
        slam = SlamSystem(cfg1)
        for i in range(6):
            slam.track_rgbd(grays[i], depths[i], i / 30.0)
        assert slam.state == TrackState.OK
        assert int(slam.map.il_valid.sum()) == 0


def test_ref_kf_fallback_recovers_large_jump():
    """A camera jump far beyond every projection window forces the
    un-windowed reference-KF fallback (TrackReferenceKeyFrame parity,
    system._track second fallback); tracking must survive without a LOST
    event (VERDICT r2 weak #10: the branch was untested)."""
    import numpy as np

    from pslam.io.synthetic import BoxRoom
    from pslam.pipeline.system import SlamSystem, TrackState

    cfg = SlamConfig(use_lines=False, use_bow=False, use_loop_closing=False)
    cam = cfg.camera
    K = np.array(
        [[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], np.float64
    )
    room = BoxRoom(seed=0)

    def pose(C):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = -np.asarray(C, np.float32)
        return T

    # Smooth start, then a 0.6 m lateral jump (~90 px at z~3.5 m — far
    # outside the 15/30 px motion windows).
    centers = [[0, 0, 0], [0.02, 0, 0.02], [0.04, 0, 0.04], [0.06, 0, 0.06],
               [0.66, 0, 0.06]]
    slam = SlamSystem(cfg)
    for i, C in enumerate(centers):
        T = pose(C)
        g, d = room.render(K, T.astype(np.float64), cam.width, cam.height)
        T_est = slam.track_rgbd(g, d, i / 30.0)
    assert slam.state == TrackState.OK
    C_est = -T_est[:3, :3].T @ T_est[:3, 3]
    err = np.linalg.norm(C_est - np.asarray(centers[-1]))
    assert err < 0.05, f"jump recovery error {err:.3f} m"
