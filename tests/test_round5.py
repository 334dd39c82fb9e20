"""Round-5 tests: ADVICE r4 fixes (slot-generation guards, fuse
double-bind guards, KF-capacity backstop), bf16 FAST flip rate."""

import numpy as np
import pytest

from pslam.utils.config import Capacities, SlamConfig


def _mini_cfg(**kw):
    return SlamConfig(
        caps=Capacities(
            max_keyframes=8, max_map_points=256, local_points=128,
            ba_cams=8, ba_free=4, ba_points=128, ba_edges=2048,
            max_map_lines=64, max_lils=32, frame_lils=8,
        ),
        use_lines=False, use_lils=False, use_bow=False,
        use_loop_closing=False, **kw,
    )


class TestGenerationGuards:
    def test_recycled_slot_changes_generation(self):
        """A culled + reallocated map-point slot must carry a new generation
        so stale snapshot consumers can detect the swap (ADVICE r4 medium:
        mp_valid alone marks a recycled slot as live again)."""
        from pslam.models.map_state import MapState

        cfg = _mini_cfg()
        m = MapState(cfg)
        N = cfg.orb.capacity
        uv = np.zeros((N, 2), np.float32)
        aux = np.zeros(N, np.float32)
        lvl = np.zeros(N, np.int32)
        desc = np.zeros((N, 32), np.uint8)
        ok = np.ones(N, bool)
        kf = m.add_keyframe(0, 0.0, np.eye(4, dtype=np.float32), uv, aux,
                            lvl, aux, desc, ok, aux + 2.0,
                            np.full(N, -1, np.int32))
        ids = m.create_points_from_depth(
            kf, np.arange(4), np.tile([0, 0, 2.0], (4, 1)).astype(np.float32)
        )
        g0 = m.mp_gen[ids].copy()
        m.cull_map_points(ids[:2])
        ids2 = m.alloc_map_points(2)  # recycles the 2 culled slots
        assert set(ids2.tolist()) == set(ids[:2].tolist())
        assert (m.mp_gen[ids2] == g0[:2] + 1).all()
        assert (m.mp_gen[ids[2:]] == g0[2:]).all()

    def test_materialize_masks_recycled_slot(self):
        """_materialize_host_frame must not bind a feature to a slot whose
        landmark was culled and replaced after the snapshot was taken."""
        from pslam.models.map_state import MapState
        from pslam.pipeline.system import HostFrame, SlamSystem

        cfg = _mini_cfg()
        s = SlamSystem(cfg)
        m = s.map
        N = cfg.orb.capacity
        uv = np.zeros((N, 2), np.float32)
        aux = np.zeros(N, np.float32)
        lvl = np.zeros(N, np.int32)
        desc = np.zeros((N, 32), np.uint8)
        okm = np.ones(N, bool)
        kf = m.add_keyframe(0, 0.0, np.eye(4, dtype=np.float32), uv, aux,
                            lvl, aux, desc, okm, aux + 2.0,
                            np.full(N, -1, np.int32))
        ids = m.create_points_from_depth(
            kf, np.arange(3), np.tile([0, 0, 2.0], (3, 1)).astype(np.float32)
        )
        s.ref_kf = kf
        s._rebuild_snapshot()
        snap_ids = s._snap_id_pack()
        # Cull id[0] and recycle its slot into a new landmark.
        m.cull_map_points(ids[:1])
        rid = m.alloc_map_points(1)
        assert rid[0] == ids[0]
        m.mp_valid[rid] = True

        # Fake a frame_step output that matched snapshot slots 0 and 1.
        M = cfg.caps.local_points
        match = np.full(M, -1, np.int32)
        match[0], match[1] = 5, 6  # feature indices
        inl = np.zeros(M, bool)
        inl[:2] = True

        class FD:  # minimal FrameData stand-in (host arrays pass through)
            pass

        fd = FD()
        fd.uv, fd.ur, fd.depth = uv, aux, aux + 2.0
        fd.xyz_c = np.zeros((N, 3), np.float32)
        fd.level, fd.angle, fd.desc, fd.valid = lvl, aux, desc, okm

        class Out:
            pass

        out = Out()
        out.fd = fd
        out.fl = None
        out.match_point = match
        out.inlier = inl
        hf = HostFrame(frame_id=1, timestamp=0.0,
                       T_cw=np.eye(4, dtype=np.float32))
        s._materialize_host_frame(hf, out, snap_ids)
        # Slot 0 was recycled (gen mismatch) -> must NOT bind; slot 1 binds.
        assert hf.feat_mp[5] == -1
        assert hf.feat_mp[6] == ids[1]


class TestFuseDoubleBind:
    def test_apply_fuse_skips_already_observed(self):
        """_apply_fuse must not bind a point to a second feature slot of the
        same KF when an earlier replace made the KF observe it (ADVICE r4)."""
        from pslam.models.map_state import MapState
        from pslam.pipeline.local_mapping import _apply_fuse

        cfg = _mini_cfg()
        m = MapState(cfg)
        N = cfg.orb.capacity
        uv = np.zeros((N, 2), np.float32)
        aux = np.zeros(N, np.float32)
        lvl = np.zeros(N, np.int32)
        desc = np.zeros((N, 32), np.uint8)
        okm = np.ones(N, bool)
        k0 = m.add_keyframe(0, 0.0, np.eye(4, dtype=np.float32), uv, aux,
                            lvl, aux, desc, okm, aux + 2.0,
                            np.full(N, -1, np.int32))
        k1 = m.add_keyframe(1, 0.1, np.eye(4, dtype=np.float32), uv, aux,
                            lvl, aux, desc, okm, aux + 2.0,
                            np.full(N, -1, np.int32))
        # a created by k0 at feat 0; b created by k1 at feat 7.
        a = int(m.create_points_from_depth(
            k0, np.asarray([0]), np.asarray([[0, 0, 2.0]], np.float32))[0])
        b = int(m.create_points_from_depth(
            k1, np.asarray([7]), np.asarray([[0, 0, 2.0]], np.float32))[0])
        m.add_point_obs(k1, [3], [a])  # k1 sees a at feat 3 too
        # Candidate list fuses a (match at k1 feat 7, where b lives -> replace
        # b into a since a has more obs) and then a AGAIN at feat 9 (free):
        # after the replace, k1 already observes a, so the second bind must
        # be skipped.
        cand = np.asarray([a, a])
        idx = np.asarray([7, 9])
        _apply_fuse(m, k1, cand, idx)
        assert int((m.kf_feat_mp[k1] == a).sum()) <= 2  # feat 3 + feat 7
        # n_obs consistency: count table references == mp_n_obs.
        assert m.mp_n_obs[a] == int((m.kf_feat_mp[: m.n_kf] == a).sum())


class TestKfCapacityBackstop:
    def test_map_level_backstop_raises(self):
        """MapState.add_keyframe must refuse to evict silently when full
        (ADVICE r4: eviction needs system-level bookkeeping)."""
        from pslam.models.map_state import MapState

        cfg = _mini_cfg()
        m = MapState(cfg)
        N = cfg.orb.capacity
        uv = np.zeros((N, 2), np.float32)
        aux = np.zeros(N, np.float32)
        lvl = np.zeros(N, np.int32)
        desc = np.zeros((N, 32), np.uint8)
        okm = np.ones(N, bool)
        for i in range(cfg.caps.max_keyframes):
            m.add_keyframe(i, i * 0.1, np.eye(4, dtype=np.float32), uv, aux,
                           lvl, aux, desc, okm, aux + 2.0,
                           np.full(N, -1, np.int32))
        with pytest.raises(RuntimeError, match="capacity"):
            m.add_keyframe(99, 9.9, np.eye(4, dtype=np.float32), uv, aux,
                           lvl, aux, desc, okm, aux + 2.0,
                           np.full(N, -1, np.int32))


class TestStereo:
    """Third sensor pipeline (VERDICT r4 item 7): Frame::ComputeStereoMatches
    (Frame.cc:1165) + Tracking::GrabImageStereo (Tracking.cc:174)."""

    def test_stereo_depth_accuracy(self):
        """Stereo-matched depths must agree with rendered ground-truth depth
        for most features (sub-pixel SAD disparity)."""
        import jax.numpy as jnp

        from pslam.io.synthetic import BoxRoom, render_sequence, \
            render_stereo_sequence
        from pslam.pipeline.frame_ops import make_frame_stereo
        from pslam.utils.config import SlamConfig

        cfg = SlamConfig(sensor="stereo", use_lines=False, use_lils=False,
                         use_bow=False, use_loop_closing=False)
        cam = cfg.camera
        room = BoxRoom(seed=1)
        gl, gr, poses = render_stereo_sequence(cam, n_frames=1, room=room)
        _, dl, _ = render_sequence(cam, n_frames=1, room=room)
        fd = make_frame_stereo(
            jnp.asarray(gl[0]), jnp.asarray(gr[0]), cam, cfg.orb
        )
        z = np.asarray(fd.depth)
        uv = np.asarray(fd.uv)
        ok = (z > 0) & np.asarray(fd.valid)
        assert ok.sum() > 300, f"only {ok.sum()} stereo depths"
        ui = np.clip(np.round(uv[ok, 0]).astype(int), 0, cam.width - 1)
        vi = np.clip(np.round(uv[ok, 1]).astype(int), 0, cam.height - 1)
        z_gt = dl[0][vi, ui]
        rel = np.abs(z[ok] - z_gt) / np.maximum(z_gt, 1e-6)
        # Sub-pixel disparity at 2-6 m: median relative depth error small,
        # and the bulk within 5% (the tail is far-wall features where one
        # disparity pixel is ~15% depth; the chi^2 gates downstream weigh
        # them accordingly).
        assert np.median(rel) < 0.02, np.median(rel)
        assert (rel < 0.05).mean() > 0.75, (rel < 0.05).mean()

    def test_stereo_end_to_end_ate(self):
        from pslam.io.synthetic import render_stereo_sequence
        from pslam.pipeline.system import SlamSystem, TrackState
        from pslam.utils.config import SlamConfig
        from pslam.utils.metrics import ate_rmse, trajectory_positions

        cfg = SlamConfig(sensor="stereo", use_lines=False, use_lils=False,
                         use_bow=False, use_loop_closing=False)
        gl, gr, poses_gt = render_stereo_sequence(cfg.camera, n_frames=20)
        s = SlamSystem(cfg)
        for i in range(len(gl)):
            s.track_stereo(gl[i], gr[i], i / 30.0)
        assert s.state == TrackState.OK
        est = trajectory_positions(s.poses)
        gt = trajectory_positions(poses_gt)
        ate = ate_rmse(est, gt)
        assert ate < 0.06, f"stereo ATE {ate:.4f} m"

    def test_stereo_requires_no_lines(self):
        from pslam.utils.config import SlamConfig

        with pytest.raises(ValueError, match="stereo"):
            SlamConfig(sensor="stereo", use_lines=True)


class TestVisualOdometryMode:
    """mbVO substance for localization-only mode (VERDICT r4 item 8,
    Tracking.cc:304-411, 1049-1162): when the frozen map leaves the view,
    tracking continues on frame-to-frame VO matches and relocalizes on
    return."""

    def test_vo_survives_leaving_map_and_relocalizes(self):
        import numpy as np

        from pslam.io.synthetic import ClosedRoom, render_sequence
        from pslam.pipeline.system import SlamSystem, TrackState
        from pslam.utils.config import SlamConfig

        cfg = SlamConfig(use_lines=False, use_lils=False)
        cam = cfg.camera

        def yaw_pose(yaw, C):
            cy, sy = np.cos(yaw), np.sin(yaw)
            R_wc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = R_wc.T
            T[:3, 3] = -R_wc.T @ np.asarray(C)
            return T

        # Phase 1 (map): small sweep looking at the back wall. Phase 2
        # (leave): yaw to 150 deg — the frozen map is fully out of view,
        # only frame-to-frame VO can carry. Phase 3 (return): yaw back.
        C0 = np.array([0.0, 0.0, 1.0])
        poses = [yaw_pose(0.04 * i, C0 + [0.02 * i, 0, 0]) for i in range(12)]
        out_yaws = np.linspace(0.44, 2.6, 14)
        poses += [yaw_pose(y, C0 + [0.24, 0, 0]) for y in out_yaws]
        poses += [yaw_pose(y, C0 + [0.24, 0, 0]) for y in out_yaws[::-1][1:]]
        poses += [yaw_pose(0.04 * i, C0 + [0.02 * i, 0, 0])
                  for i in range(11, 7, -1)]
        poses = np.stack(poses).astype(np.float32)
        room = ClosedRoom(depth=5.0, half_w=3.0, half_h=2.0, seed=4)
        grays, depths, _ = render_sequence(cam, poses=poses, room=room)

        s = SlamSystem(cfg)
        for i in range(12):
            s.track_rgbd(grays[i], depths[i], i / 30.0)
        assert s.state == TrackState.OK
        s.activate_localization_mode()

        lost_frames = 0
        for i in range(12, len(grays)):
            s.track_rgbd(grays[i], depths[i], i / 30.0)
            if s.state == TrackState.LOST:
                lost_frames += 1
        # The excursion must be survived by VO (some frames in VO mode),
        # and the return must end tracked against the map again.
        assert s.stats.get("vo_frames", 0) >= 3, s.stats
        assert s.state == TrackState.OK
        assert not s._vo_mode  # back on map inliers (reloc or direct match)
        assert lost_frames <= 4, lost_frames


def test_fast_bf16_flip_rate():
    """Quantify the bf16-vs-f32 FAST decision flip rate on an interpolated
    pyramid level (ADVICE r4 low: bf16 exactness only holds for integer
    level-0 pixels)."""
    import jax.numpy as jnp

    from pslam.ops.fast import fast_score_dual

    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (1, 256, 256)).astype(np.float32)
    # Interpolated level: 1.2x downscale via bilinear-ish averaging.
    k = np.array([0.25, 0.5, 0.25])
    sm = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, img[0])
    sm = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 0, sm)
    lvl = sm[None, ::1, ::1].astype(np.float32)  # non-integer values

    hi_f, lo_f, _ = fast_score_dual(jnp.asarray(lvl, jnp.float32), 20, 7)
    # Reference f32 path: emulate by pre-rounding to bf16 on host and
    # comparing decisions (the jitted kernel always casts to bf16; the f32
    # "truth" is computed here in numpy).
    from pslam.ops.fast import CIRCLE

    def fast_np(a, th):
        masks_b = np.zeros(a.shape, np.int32)
        masks_d = np.zeros(a.shape, np.int32)
        for s, (dx, dy) in enumerate(CIRCLE):
            sh = np.roll(np.roll(a, dy, axis=1), dx, axis=2)
            diff = sh - a
            masks_b |= (diff > th).astype(np.int32) << s
            masks_d |= (diff < -th).astype(np.int32) << s

        def arc9(m):
            mm = m | (m << 16)
            out = np.zeros(m.shape, bool)
            for start in range(16):
                out |= (mm >> start) & 0x1FF == 0x1FF
            return out

        return arc9(masks_b) | arc9(masks_d)

    truth = fast_np(lvl.astype(np.float64), 20.0)
    got = np.asarray(hi_f, bool)
    flips = np.logical_xor(truth, got)[:, 8:-8, 8:-8]
    rate = flips.mean()
    assert rate < 0.005, f"bf16 flip rate {rate:.4%} exceeds 0.5%"
