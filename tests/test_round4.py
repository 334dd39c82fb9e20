"""Round-4 feature tests: PnP fallback, depth-hole relocalization,
LIL probation culling, graceful KF capacity, localization-only mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pslam.geometry import se3_exp
from pslam.utils.config import (
    Capacities,
    PlaneAssocConfig,
    SlamConfig,
    TrackingConfig,
)


def _random_pose(rng, rot=0.2, trans=0.3):
    xi = np.r_[rng.normal(0, trans, 3), rng.normal(0, rot, 3)].astype(
        np.float32
    )
    return np.asarray(se3_exp(jnp.asarray(xi)))


class TestPnPRansac:
    def test_recovers_pose_with_outliers(self):
        from pslam.solver.pnp import pnp_ransac_2d3d

        cfg = SlamConfig()
        cam = cfg.camera
        rng = np.random.default_rng(0)
        T_gt = _random_pose(rng)
        N = 256
        X_w = rng.uniform([-2, -2, 2], [2, 2, 6], (N, 3)).astype(np.float32)
        Xc = X_w @ T_gt[:3, :3].T + T_gt[:3, 3]
        u = cam.fx * Xc[:, 0] / Xc[:, 2] + cam.cx
        v = cam.fy * Xc[:, 1] / Xc[:, 2] + cam.cy
        uv = np.stack([u, v], axis=-1).astype(np.float32)
        uv += rng.normal(0, 0.5, uv.shape).astype(np.float32)
        # 30% gross outliers.
        n_out = N * 3 // 10
        uv[:n_out] = rng.uniform(0, 600, (n_out, 2)).astype(np.float32)
        valid = np.ones(N, bool)

        T, inl, n = pnp_ransac_2d3d(
            cam, jnp.asarray(X_w), jnp.asarray(uv), jnp.asarray(valid),
            jax.random.PRNGKey(0),
        )
        T = np.asarray(T)
        assert int(n) > 0.8 * (N - n_out)
        assert np.linalg.norm(T[:3, 3] - T_gt[:3, 3]) < 0.05
        assert np.abs(T[:3, :3] - T_gt[:3, :3]).max() < 0.02

    def test_depth_sparse_branch_selected(self):
        """reloc_bow_step must produce a usable pose when ~80% of matched
        features fall in depth holes (VERDICT r3 item 9 done criterion)."""
        from pslam.pipeline.frame_ops import make_frame
        from pslam.pipeline.relocalization import reloc_bow_step
        from pslam.io.synthetic import render_sequence

        cfg = SlamConfig()
        cam, orb = cfg.camera, cfg.orb
        grays, depths, poses = render_sequence(cam, n_frames=2, seed=5)
        # Punch depth holes over ~97% of the image (one 16-px column stripe
        # keeps depth) so <12 matched features carry depth and the uv-only
        # PnP branch must carry the solve.
        dep = depths[1].copy()
        H, W = dep.shape
        mask = np.arange(W)[None, :] // 8 != 20
        dep[np.broadcast_to(mask, (H, W))] = 0.0

        fd_full = make_frame(
            jnp.asarray(grays[0]), jnp.asarray(depths[0]), cam, orb
        )
        fd_holes = make_frame(jnp.asarray(grays[1]), jnp.asarray(dep), cam, orb)

        # Build the "keyframe" side from frame 0 with full depth: world
        # points via its ground-truth pose.
        T0 = poses[0]
        T0_inv = np.linalg.inv(T0)
        xyz_c = np.asarray(fd_full.xyz_c)
        has = np.asarray((fd_full.depth > 0) & fd_full.valid)
        X_w = (xyz_c @ T0_inv[:3, :3].T) + T0_inv[:3, 3]
        sigma2 = np.asarray(
            [(orb.scale**l) ** 2 for l in range(orb.levels)], np.float32
        )
        nodes = np.zeros(len(has), np.int32)  # single BoW bucket
        res = reloc_bow_step(
            cam,
            jnp.asarray(X_w.astype(np.float32)),
            jnp.asarray(has),
            fd_full.desc,
            fd_full.angle,
            jnp.asarray(nodes),
            fd_holes,
            jnp.asarray(nodes),
            jnp.asarray(sigma2),
            jax.random.PRNGKey(1),
        )
        # Depth-backed matches must be scarce, so the PnP branch ran.
        n_depth_matches = int(
            np.asarray(
                jnp.sum(
                    (res.match_idx >= 0)
                    & (fd_holes.depth[jnp.maximum(res.match_idx, 0)] > 0)
                )
            )
        )
        assert n_depth_matches < 12, "test setup: depth holes not sparse enough"
        T1_gt = poses[1]
        T = np.asarray(res.T_cw)
        assert int(res.n_inliers) >= 30
        assert np.linalg.norm(T[:3, 3] - T1_gt[:3, 3]) < 0.10


class TestLILProbation:
    def test_immature_lils_culled(self):
        from pslam.models.map_state import MapState
        from pslam.pipeline.line_mapping import cull_lils_by_quality

        cfg = SlamConfig(
            plane_assoc=PlaneAssocConfig(observe_th=3, probation_kfs=2)
        )
        m = MapState(cfg)
        # Fake keyframe sequence bookkeeping.
        m.kf_seq[0] = 0
        m.next_kf_seq = 1
        ids = m.create_lils(
            0,
            np.asarray([0, 1]),
            np.zeros((2, 15), np.float32),
            np.tile(np.asarray([0, 0, 1, 1], np.float32), (2, 1)),
            np.zeros((2, 8), np.float32),
        )
        # LIL 0 matures: frame obs above threshold + a second KF observation.
        m.il_frame_obs[ids[0]] = 10
        m.il_n_obs[ids[0]] = 2
        # Advance past probation.
        m.next_kf_seq = 5
        n = cull_lils_by_quality(m, cfg)
        assert n == 1
        assert m.il_valid[ids[0]]
        assert not m.il_valid[ids[1]]


class TestKeyframeCapacity:
    def test_system_eviction_keeps_capacity(self):
        """Round-5 contract change (ADVICE r4): the MAP-level backstop no
        longer evicts silently (it raises — test_round5 covers that);
        capacity pressure must be handled by SlamSystem._evict_for_capacity
        with full bookkeeping. Fill the table via the system helper and
        check eviction keeps the map valid."""
        from pslam.models.map_state import MapState
        from pslam.pipeline.system import SlamSystem

        cfg = SlamConfig(use_bow=False, use_loop_closing=False)
        s = SlamSystem(cfg)
        m = s.map
        cap = m.kf_valid.shape[0]
        rng = np.random.default_rng(0)
        N = m.kf_uv.shape[1]
        uv = rng.uniform(0, 400, (N, 2)).astype(np.float32)
        args = dict(
            ur=np.full(N, -1, np.float32),
            level=np.zeros(N, np.int32),
            angle=np.zeros(N, np.float32),
            desc=np.zeros((N, 32), np.uint8),
            feat_valid=np.ones(N, bool),
            depth=np.ones(N, np.float32),
            feat_mp=np.full(N, -1, np.int32),
        )
        for i in range(cap + 3):  # 3 past capacity: must not raise
            s._evict_for_capacity()
            k = m.add_keyframe(
                i, i * 0.1, np.eye(4, dtype=np.float32), uv, **args
            )
            s.ref_kf = k
        assert m.kf_valid.sum() <= cap
        assert s.stats.get("kf_evicted", 0) >= 3


def _drive(system, grays, depths, n, t0=0.0):
    for i in range(n):
        system.track_rgbd(grays[i], depths[i], t0 + i / 30.0)


class TestLocalizationOnly:
    @pytest.fixture(scope="class")
    def seq(self):
        from pslam.io.synthetic import render_sequence

        cfg = SlamConfig()
        return render_sequence(cfg.camera, n_frames=70, seed=2)

    def test_freezes_backend_and_recovers(self, seq):
        from pslam.pipeline.system import SlamSystem, TrackState

        grays, depths, poses_gt = seq
        cfg = SlamConfig()
        s = SlamSystem(cfg)
        _drive(s, grays, depths, 15)
        assert s.state == TrackState.OK
        kfs_before = s.stats["kf_inserted"]

        # activate flushes the async-dispatched KF backend (round-5: the
        # last KF's triangulation/fuse commit here), so count landmarks
        # AFTER the freeze point.
        s.activate_localization_mode()
        mp_count = int(s.map.mp_valid.sum())
        # 50 tracked frames: zero KF insertions, zero new landmarks.
        for i in range(15, 65):
            s.track_rgbd(grays[i], depths[i], i / 30.0)
        assert s.stats["kf_inserted"] == kfs_before
        assert int(s.map.mp_valid.sum()) == mp_count
        assert s.state == TrackState.OK

        # Blackout: featureless frames lose tracking...
        black = np.zeros_like(grays[0])
        nodep = np.zeros_like(depths[0])
        for j in range(3):
            s.track_rgbd(black, nodep, 3.0 + j / 30.0)
        assert s.state == TrackState.LOST
        assert s.stats.get("resets", 0) == 0  # no hard reset in loc-only mode

        # ...and recover via relocalization on a revisited view.
        for j in range(3):
            s.track_rgbd(grays[20 + j], depths[20 + j], 4.0 + j / 30.0)
            if s.state == TrackState.OK:
                break
        assert s.state == TrackState.OK
        assert s.stats.get("relocs", 0) >= 1
        assert s.stats["kf_inserted"] == kfs_before


class TestPipelinedTracking:
    def test_matches_sync_ate(self):
        """track_rgbd_pipelined (depth-1 overlap) produces the same
        trajectory quality as the synchronous path and records every
        frame."""
        from pslam.io.synthetic import render_sequence
        from pslam.pipeline.system import SlamSystem, TrackState
        from pslam.utils.metrics import ate_rmse, trajectory_positions

        cfg = SlamConfig()
        n = 20
        grays, depths, poses_gt = render_sequence(
            cfg.camera, n_frames=n, seed=1
        )

        s_sync = SlamSystem(cfg)
        for i in range(n):
            s_sync.track_rgbd(grays[i], depths[i], i / 30.0)

        s_pipe = SlamSystem(cfg)
        for i in range(n):
            s_pipe.track_rgbd_pipelined(grays[i], depths[i], i / 30.0)
        s_pipe.finish()

        assert s_pipe.state == TrackState.OK
        assert len(s_pipe.trajectory) == n
        gt = trajectory_positions(poses_gt)
        ate_s = ate_rmse(trajectory_positions(s_sync.poses), gt)
        ate_p = ate_rmse(trajectory_positions(s_pipe.poses), gt)
        assert ate_p < 0.05, f"pipelined ATE {ate_p:.4f} m"
        # Same ballpark as sync (the pipelined KF policy lags one frame).
        assert ate_p < max(2.5 * ate_s, 0.03)

    def test_mixed_mode_drains(self):
        from pslam.io.synthetic import render_sequence
        from pslam.pipeline.system import SlamSystem

        cfg = SlamConfig(use_lines=False, use_bow=False,
                         use_loop_closing=False)
        grays, depths, _ = render_sequence(cfg.camera, n_frames=8, seed=2)
        s = SlamSystem(cfg)
        for i in range(4):
            s.track_rgbd_pipelined(grays[i], depths[i], i / 30.0)
        # Switching to the sync API drains the in-flight frame first.
        s.track_rgbd(grays[4], depths[4], 4 / 30.0)
        assert s._inflight is None
        assert len(s.trajectory) == 5
        for i in range(5, 8):
            s.track_rgbd_pipelined(grays[i], depths[i], i / 30.0)
        s.finish()
        assert len(s.trajectory) == 8


class TestMonocular:
    def test_mono_init_and_tracking(self):
        """Minimal monocular pipeline (VERDICT r3 item 10): H/F two-view
        init + depthless tracking; ATE evaluated up to scale (mono gauge)."""
        from pslam.io.synthetic import render_sequence
        from pslam.pipeline.system import SlamSystem, TrackState
        from pslam.utils.metrics import ate_rmse, trajectory_positions

        cfg = SlamConfig(use_lines=False, use_loop_closing=False)
        n = 14
        grays, depths, poses_gt = render_sequence(cfg.camera, n_frames=n,
                                                  seed=6)
        s = SlamSystem(cfg)
        for i in range(n):
            s.track_mono(grays[i], i / 30.0)
        assert s.state == TrackState.OK
        assert s.map.n_kf >= 2
        assert int(s.map.mp_valid.sum()) > 80
        # All map points are mono observations (no depth anywhere).
        assert float(s.map.kf_feat_depth[: s.map.n_kf].max()) == 0.0
        est = trajectory_positions(s.poses)
        gt = trajectory_positions(poses_gt)
        ate = ate_rmse(est, gt[: len(est)], with_scale=True)
        assert ate < 0.08, f"mono ATE (scale-aligned) {ate:.4f} m"


class TestLineThresholdSensitivity:
    def test_desc_th_not_knife_edge(self):
        """r3 weak #8: the line-matching descriptor gate (DESC_TH on the
        [0,4] squared-L2 scale) is calibrated on synthetic data; verify the
        operating point is on a plateau — +-25% threshold shifts must not
        collapse match count or correctness on a ground-truthed pair."""
        import jax.numpy as jnp

        from pslam.io.synthetic import render_sequence
        from pslam.ops.line_match import DESC_TH, match_lines_f2f
        from pslam.pipeline.frame_ops import make_frame_lines

        cfg = SlamConfig()
        cam = cfg.camera
        grays, depths, poses = render_sequence(cam, n_frames=2, seed=8)
        fl0 = make_frame_lines(
            jnp.asarray(grays[0]), jnp.asarray(depths[0]), cam, cfg.lines
        )
        fl1 = make_frame_lines(
            jnp.asarray(grays[1]), jnp.asarray(depths[1]), cam, cfg.lines
        )

        # Ground truth: project frame-0 3D midpoints into frame 1; a match
        # is correct when the matched segment lies near that projection.
        T01 = poses[1] @ np.linalg.inv(poses[0])
        mid0 = 0.5 * (np.asarray(fl0.p3s) + np.asarray(fl0.p3e))
        ok3 = np.asarray(fl0.ok3d) & np.asarray(fl0.valid)
        mid1 = mid0 @ T01[:3, :3].T + T01[:3, 3]
        z = np.maximum(mid1[:, 2], 1e-9)
        u = cam.fx * mid1[:, 0] / z + cam.cx
        v = cam.fy * mid1[:, 1] / z + cam.cy

        sp1 = np.asarray(fl1.sp)
        ep1 = np.asarray(fl1.ep)

        def correct_count(th):
            idx, _ = match_lines_f2f(
                fl0.desc, fl0.sp, fl0.ep, fl0.valid,
                fl1.desc, fl1.sp, fl1.ep, fl1.valid,
                float(cam.width), float(cam.height), max_dist=th,
            )
            idx = np.asarray(idx)
            good = 0
            for i in np.flatnonzero((idx >= 0) & ok3):
                j = idx[i]
                m1 = 0.5 * (sp1[j] + ep1[j])
                # Distance from the projected midpoint to the matched
                # segment's midpoint, along the segment normal (endpoints
                # slide along the line between detections).
                d = ep1[j] - sp1[j]
                nrm = np.array([-d[1], d[0]])
                nrm = nrm / max(np.linalg.norm(nrm), 1e-9)
                perp = abs((np.array([u[i], v[i]]) - m1) @ nrm)
                if perp < 12.0:
                    good += 1
            return good

        base = correct_count(DESC_TH)
        lo = correct_count(DESC_TH * 0.75)
        hi = correct_count(DESC_TH * 1.25)
        assert base >= 10, f"too few correct line matches at default: {base}"
        assert lo >= 0.6 * base, (lo, base)
        assert hi >= 0.8 * base, (hi, base)
