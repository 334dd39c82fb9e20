"""System facade + tracking orchestration.

Replaces System (reference src/System.cc) and the Tracking state machine
(src/Tracking.cc): per-frame entry point, initialization, motion-model
tracking, local-map tracking, keyframe policy, trajectory bookkeeping.

Host/device split: the host keeps MapState and makes control decisions; each
frame costs a small fixed number of fused device dispatches (extract+stereo,
track vs previous matches, track vs local map).
"""

from __future__ import annotations

import dataclasses
import enum

import jax
import jax.numpy as jnp
import numpy as np

from pslam.models.map_state import MapState
from pslam.pipeline import frame_step as fstep
from pslam.pipeline import line_mapping, local_mapping
from pslam.pipeline.frame_ops import (
    FrameData,
    FrameLineData,
    make_frame,
    make_frame_lines,
)
from pslam.pipeline.track_ops import PointSet
from pslam.solver.ba_lil import local_bundle_adjustment_lil
from pslam.solver.local_ba import local_bundle_adjustment
from pslam.utils.config import SlamConfig


class TrackState(enum.Enum):
    # Mirrors Tracking::eTrackingState (Tracking.h:90-96).
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


@dataclasses.dataclass
class HostFrame:
    """Host copy of a processed frame + its tracking results.

    On the fused tracking path only (frame_id, timestamp, T_cw) are
    populated per frame; the feature arrays are fetched from the device
    lazily, at keyframe insertion (VERDICT r3 item 2: fetch only the small
    results per frame)."""

    frame_id: int
    timestamp: float
    T_cw: np.ndarray  # (4, 4)
    uv: np.ndarray | None = None
    ur: np.ndarray | None = None
    depth: np.ndarray | None = None
    xyz_c: np.ndarray | None = None
    level: np.ndarray | None = None
    angle: np.ndarray | None = None
    desc: np.ndarray | None = None
    valid: np.ndarray | None = None
    feat_mp: np.ndarray | None = None  # map point id per feature, -1 = none
    # Line features (present when cfg.use_lines).
    line_sp: np.ndarray | None = None
    line_ep: np.ndarray | None = None
    line_desc: np.ndarray | None = None
    line_valid: np.ndarray | None = None
    line_p3s: np.ndarray | None = None
    line_p3e: np.ndarray | None = None
    line_ok3d: np.ndarray | None = None
    line_ml: np.ndarray | None = None  # map-line id per line slot, -1 none
    lil: FrameLineData | None = None  # .lil LILFeatures (device arrays ok)
    lil_il: np.ndarray | None = None  # map-InsectLine id per LIL slot


class SlamSystem:
    def __init__(self, cfg: SlamConfig | None = None, vocab=None):
        self.cfg = cfg or SlamConfig()
        self.map = MapState(self.cfg)
        self.state = TrackState.NO_IMAGES_YET
        self.frame_id = 0
        self.velocity = np.eye(4, dtype=np.float32)
        self.last: HostFrame | None = None
        self.ref_kf = 0
        # Trajectory rows are (ts, T_rel, ref_kf): the frame pose RELATIVE to
        # its reference keyframe (mlRelativeFramePoses, Tracking.cc:534-551),
        # chained against the CURRENT (loop-corrected) KF pose at save time
        # (System::SaveTrajectoryTUM, System.cc:323-384). ref_kf == -1 marks a
        # row frozen to an absolute pose (pre-reset history).
        self.trajectory: list[tuple[float, np.ndarray, int]] = []
        self.stats = {"ba_runs": 0, "culled": 0, "kf_inserted": 0}
        # Device-resident tracking snapshot + accumulators (frame_step.py)
        # and the in-flight (async-dispatched) local BA.
        self._snap = None
        self._acc = None
        self._snap_pt_ids = np.zeros(0, np.int64)
        self._snap_ml_ids = np.zeros(0, np.int64)
        self._snap_il_ids = np.zeros(0, np.int64)
        # Allocation generations captured WITH the ids (ADVICE r4 medium: a
        # slot culled + recycled between snapshot build and consumption is
        # valid again but holds a different landmark; gen mismatch masks it).
        self._snap_pt_gen = np.zeros(0, np.int64)
        self._snap_ml_gen = np.zeros(0, np.int64)
        self._snap_il_gen = np.zeros(0, np.int64)
        self._pending_ba = None
        # Async-dispatched KF backend (triangulation + fuse) committed at
        # the NEXT keyframe event — completes the LocalMapping-thread
        # analogue (System.cc:86-113): no frame blocks on backend device
        # work (VERDICT r4 item 3).
        self._pending_backend = None
        self._snap_epoch = 0
        self._fresh_acc = False
        self._inflight = None  # depth-1 pipelined frame (track_rgbd_pipelined)
        # Localization-only mode (System::ActivateLocalizationMode,
        # System.cc:270-283): backend frozen, tracking against the frozen
        # map; _vo_mode mirrors mbVO (Tracking.cc:304-411) — few map
        # inliers while only-tracking => try relocalization opportunistically.
        self.localization_only = False
        self._vo_mode = False
        # Previous frame's device FrameData + pose, kept ONLY in
        # localization-only mode for the mbVO frame-to-frame fallback.
        self._vo_prev = None
        # Place recognition DB (System.cc:61-82: vocabulary + KeyFrameDatabase;
        # trained at startup instead of parsing ORBvoc.txt for minutes).
        self.kf_db = None
        if self.cfg.use_bow:
            from pslam.ops.bow import default_vocabulary
            from pslam.pipeline.keyframe_db import KeyFrameDatabase

            if vocab is None:
                vocab = default_vocabulary(
                    k=self.cfg.bow_k, levels=self.cfg.bow_levels
                )
            self.kf_db = KeyFrameDatabase(
                vocab, self.cfg.caps.max_keyframes, self.cfg.orb.capacity
            )
        # Loop closing (LoopClosing thread in the reference — shipped
        # disabled there, enabled here per BASELINE config 4).
        self.loop_closer = None
        if self.cfg.use_loop_closing and self.kf_db is not None:
            from pslam.pipeline.loop_closing import LoopCloser

            self.loop_closer = LoopCloser(self)

    # ------------------------------------------------------------------

    def track_rgbd(self, gray: np.ndarray, depth: np.ndarray, timestamp: float):
        """Process one RGB-D frame; returns the (4, 4) world->cam pose
        (System::TrackRGBD, System.cc:169)."""
        if self._inflight is not None:
            self._drain_pipeline()
        cam, orb = self.cfg.camera, self.cfg.orb
        gray_d = jnp.asarray(gray, jnp.float32)
        depth_d = jnp.asarray(depth, jnp.float32)

        if self.state == TrackState.OK:
            hf = self._track_fused(gray_d, depth_d, timestamp)
        else:
            fd: FrameData = self._make_frame(gray_d, depth_d)
            hf = self._to_host(fd, timestamp)
            if self.cfg.use_lines:
                fl: FrameLineData = make_frame_lines(
                    gray_d, depth_d, cam, self.cfg.lines,
                    self.cfg.caps.frame_lils,
                )
                self._lines_to_host(hf, fl)
            if self.state in (
                TrackState.NO_IMAGES_YET, TrackState.NOT_INITIALIZED
            ):
                self._initialize(hf, fd)
                self._invalidate_snapshot(fold=False)
            else:  # LOST: relocalization, or hard reset on a tiny map
                # (Tracking.cc:327, 518-526; System::Reset, System.cc:294).
                from pslam.pipeline.relocalization import relocalize

                if (
                    not self.localization_only
                    and self.map.n_kf
                    <= self.cfg.tracking.reset_if_lost_with_kfs
                ):
                    self.reset()
                    self._initialize(hf, fd)
                    self._invalidate_snapshot(fold=False)
                elif relocalize(self, hf, fd):
                    self.state = TrackState.OK
                    self.velocity = np.eye(4, dtype=np.float32)
                    self._invalidate_snapshot()
                elif self.last is not None:
                    hf.T_cw = self.last.T_cw.copy()

        self.frame_id += 1
        self._commit_frame(hf)
        return hf.T_cw

    def _commit_frame(self, hf: HostFrame):
        """Trajectory bookkeeping for a finished frame (Tracking.cc:534-551
        relative-pose rows vs the reference keyframe)."""
        self.last = hf
        if self.state == TrackState.OK and self.map.n_kf > 0:
            T_rel = hf.T_cw @ np.linalg.inv(self.map.kf_pose[self.ref_kf])
            self.trajectory.append(
                (hf.timestamp, T_rel.astype(np.float32), int(self.ref_kf))
            )
        else:
            self.trajectory.append((hf.timestamp, hf.T_cw.copy(), -1))

    def _make_frame(self, gray_d, depth_d) -> FrameData:
        """Sensor-dispatched frame construction (the ``depth`` slot carries
        the right image in stereo mode — SlamConfig.sensor)."""
        if self.cfg.sensor == "stereo":
            from pslam.pipeline.frame_ops import make_frame_stereo

            return make_frame_stereo(
                gray_d, depth_d, self.cfg.camera, self.cfg.orb
            )
        return make_frame(gray_d, depth_d, self.cfg.camera, self.cfg.orb)

    # ------------------------------------------------------------------
    # Stereo pipeline (System::TrackStereo, Tracking::GrabImageStereo,
    # Tracking.cc:174-213)

    def track_stereo(self, gray_l: np.ndarray, gray_r: np.ndarray,
                     timestamp: float):
        """Process one rectified stereo pair; returns the (4, 4) pose.
        Identical to the RGB-D pipeline downstream of the frame ctor —
        per-feature depth comes from the row-banded SAD stereo matcher
        (ops/stereo.py; Frame::ComputeStereoMatches, Frame.cc:1165) instead
        of the depth map. Requires cfg.sensor == "stereo"."""
        assert self.cfg.sensor == "stereo", "set SlamConfig(sensor='stereo')"
        return self.track_rgbd(gray_l, gray_r, timestamp)

    # ------------------------------------------------------------------
    # Monocular pipeline (System::TrackMonocular, Tracking.cc:245-272)

    def track_mono(self, gray: np.ndarray, timestamp: float):
        """Monocular tracking: H/F two-view initialization
        (Tracking::MonocularInitialization, Tracking.cc:659-757, via
        solver/initializer.py) creating a median-depth-normalized map, then
        the standard fused tracking path with mono (ur < 0) observations.
        New landmarks come from epipolar triangulation only; relocalization
        uses the uv-only PnP branch (no depth anywhere). Returns the (4, 4)
        pose."""
        if self.state in (TrackState.OK, TrackState.LOST):
            return self.track_rgbd(
                gray, np.zeros_like(np.asarray(gray), np.float32), timestamp
            )
        cam, orb = self.cfg.camera, self.cfg.orb
        gray_d = jnp.asarray(gray, jnp.float32)
        depth0 = jnp.zeros_like(gray_d)
        fd = make_frame(gray_d, depth0, cam, orb)
        hf = self._to_host(fd, timestamp)
        ref = getattr(self, "_mono_ref", None)
        if ref is None or not self._try_mono_init(ref, hf):
            # Keep the newest frame as the initialization reference
            # (the reference resets mInitialFrame each failed attempt,
            # Tracking.cc:673-686).
            self._mono_ref = hf
            self.state = TrackState.NOT_INITIALIZED
        else:
            self._mono_ref = None
            self.state = TrackState.OK
            self._invalidate_snapshot(fold=False)
        self.frame_id += 1
        self._commit_frame(hf)
        return hf.T_cw

    def _try_mono_init(self, ref: HostFrame, hf: HostFrame) -> bool:
        """Two-view initialization between the reference frame and the
        current frame; on success builds the initial two-keyframe map
        (CreateInitialMapMonocular, Tracking.cc:759-884)."""
        from pslam.ops.match import (
            TH_LOW,
            hamming_matrix,
            mutual_nn_match,
            window_mask,
        )
        from pslam.solver.initializer import initialize_two_view

        cam = self.cfg.camera
        dist = hamming_matrix(jnp.asarray(ref.desc), jnp.asarray(hf.desc))
        # 100-px window + ratio 0.9 (SearchForInitialization,
        # ORBmatcher.cc:364: windowSize=100, mfNNratio 0.9).
        box = window_mask(jnp.asarray(ref.uv), jnp.asarray(hf.uv), 100.0)
        idx, _ = jax.device_get(
            mutual_nn_match(
                dist, valid_a=jnp.asarray(ref.valid),
                valid_b=jnp.asarray(hf.valid),
                max_dist=TH_LOW, ratio=0.9, extra_mask=box,
            )
        )
        m = idx >= 0
        if m.sum() < 100:  # Tracking.cc:699 (nmatches < 100 -> retry)
            return False
        uv2 = np.zeros_like(ref.uv)
        uv2[m] = hf.uv[idx[m]]
        res = jax.device_get(
            initialize_two_view(
                jnp.asarray(ref.uv), jnp.asarray(uv2), jnp.asarray(m),
                jax.random.PRNGKey(hf.frame_id),
                fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
            )
        )
        if not bool(res.ok) or int(res.n_good) < 80:
            return False

        good = res.triangulated & m
        X1 = res.X1
        # Scale gauge: median scene depth -> 1
        # (CreateInitialMapMonocular, Tracking.cc:828-840).
        med = float(np.median(X1[good][:, 2]))
        if med <= 1e-6:
            return False
        X1 = (X1 / med).astype(np.float32)
        T0 = np.eye(4, dtype=np.float32)
        T1 = np.eye(4, dtype=np.float32)
        T1[:3, :3] = res.R21
        T1[:3, 3] = res.t21 / med

        m_ = self.map
        ref.T_cw = T0
        hf.T_cw = T1
        kf0 = m_.add_keyframe(
            ref.frame_id, ref.timestamp, T0, ref.uv, ref.ur, ref.level,
            ref.angle, ref.desc, ref.valid, ref.depth,
            np.full_like(ref.feat_mp, -1),
        )
        kf1 = m_.add_keyframe(
            hf.frame_id, hf.timestamp, T1, hf.uv, hf.ur, hf.level,
            hf.angle, hf.desc, hf.valid, hf.depth,
            np.full_like(hf.feat_mp, -1),
        )
        sel0 = np.flatnonzero(good)
        ids = m_.create_points_from_depth(kf0, sel0, X1[sel0])
        m_.add_point_obs(kf1, idx[sel0], ids)
        ref.feat_mp[sel0] = ids
        hf.feat_mp[idx[sel0]] = ids
        m_._update_covisibility(kf0)
        m_._update_covisibility(kf1)
        m_.update_point_stats(ids)
        self._register_kf_bow(kf0, ref)
        self._register_kf_bow(kf1, hf)
        self.ref_kf = kf1
        self.velocity = np.eye(4, dtype=np.float32)
        self.stats["kf_inserted"] += 2
        return True

    # ------------------------------------------------------------------
    # Depth-1 pipelined tracking

    def track_rgbd_pipelined(self, gray, depth, timestamp: float):
        """Pipelined variant of track_rgbd: dispatches THIS frame chained
        off the previous frame's device-resident pose (no host fetch on the
        critical path) and then finishes the PREVIOUS frame. Returns the
        previous frame's (4, 4) pose, or None on the priming call.

        One frame of output latency buys full overlap of the device program
        with host work and transfer round trips — the analogue of the
        reference's tracking/LocalMapping thread split (System.cc:86-113)
        applied at frame granularity. Call finish() after the last frame.
        """
        if self.state != TrackState.OK:
            self._drain_pipeline()
            self.track_rgbd(gray, depth, timestamp)
            return self.last.T_cw if self.last is not None else None
        gray_d = jnp.asarray(gray, jnp.float32)
        depth_d = jnp.asarray(depth, jnp.float32)
        if self._snap is None:
            self._rebuild_snapshot()
        prev = self._inflight
        if prev is None or self._fresh_acc or prev["epoch"] != self._snap_epoch:
            # Chain off committed host state (fresh pipeline / new snapshot).
            T_in = jnp.asarray(
                self.last.T_cw if prev is None else prev["pose_hint"]
            )
            v_in = jnp.asarray(self.velocity)
            acc_in = self._acc
            self._fresh_acc = False
        else:
            T_in, v_in, acc_in = (
                prev["out"].T_cw, prev["out"].vel, prev["out"].acc
            )
        out = fstep.frame_step(
            self.cfg, gray_d, depth_d, T_in, v_in,
            self.cfg.tracking.motion_match_radius, self._snap, acc_in,
        )
        item = {
            "out": out,
            "gray_d": gray_d,
            "depth_d": depth_d,
            "ts": float(timestamp),
            "fid": self.frame_id,
            "epoch": self._snap_epoch,
            "snap_ids": self._snap_id_pack(),
            # Device pose passed to the next dispatch even if this frame is
            # finished (and possibly retried) before then.
            "pose_hint": out.T_cw,
        }
        self.frame_id += 1
        self._inflight = item
        if prev is None:
            return None
        return self._finish_pipelined(prev)

    def _finish_pipelined(self, item) -> np.ndarray:
        hf = self._finish_frame(
            item["out"], item["gray_d"], item["depth_d"], item["ts"],
            item["fid"], item["epoch"], item["snap_ids"],
        )
        self._commit_frame(hf)
        return hf.T_cw

    def _drain_pipeline(self):
        item = self._inflight
        self._inflight = None
        if item is not None:
            self._finish_pipelined(item)

    def finish(self):
        """Flush the pipelined tracker: finish the in-flight frame (if any)
        and commit pending device work."""
        self._drain_pipeline()
        self.flush()

    # ------------------------------------------------------------------

    def _to_host(self, fd: FrameData, timestamp) -> HostFrame:
        # One batched device_get (one transfer) instead of 8 fetches.
        uv, ur, depth, xyz_c, level, angle, desc, valid = jax.device_get(
            (fd.uv, fd.ur, fd.depth, fd.xyz_c, fd.level, fd.angle, fd.desc,
             fd.valid)
        )
        return HostFrame(
            frame_id=self.frame_id,
            timestamp=float(timestamp),
            T_cw=np.eye(4, dtype=np.float32),
            uv=uv,
            ur=ur,
            depth=depth,
            xyz_c=xyz_c,
            level=level,
            angle=angle,
            desc=desc,
            valid=valid,
            feat_mp=np.full(fd.uv.shape[0], -1, np.int32),
        )

    def _lines_to_host(self, hf: HostFrame, fl: FrameLineData):
        (
            hf.line_sp, hf.line_ep, hf.line_desc, hf.line_valid,
            hf.line_p3s, hf.line_p3e, hf.line_ok3d,
        ) = jax.device_get(
            (fl.sp, fl.ep, fl.desc, fl.valid, fl.p3s, fl.p3e, fl.ok3d)
        )
        hf.line_ml = np.full(len(hf.line_valid), -1, np.int32)
        hf.lil = jax.device_get(fl.lil)
        hf.lil_il = np.full(self.cfg.caps.frame_lils, -1, np.int32)

    def _initialize(self, hf: HostFrame, fd: FrameData):
        """StereoInitialization (Tracking.cc:555-657): need enough
        depth-valid features, create the first KF and its map points."""
        n_depth = int((hf.depth > 0).sum())
        # Reference gate is a fixed 500 with a 1000-feature budget
        # (Tracking.cc:560); scale it to the configured capacity.
        if n_depth < min(500, self.cfg.orb.capacity // 2):
            self.state = TrackState.NOT_INITIALIZED
            return
        hf.T_cw = np.eye(4, dtype=np.float32)
        kf = self.map.add_keyframe(
            hf.frame_id, hf.timestamp, hf.T_cw, hf.uv, hf.ur, hf.level, hf.angle,
            hf.desc, hf.valid, hf.depth, np.full_like(hf.feat_mp, -1),
        )
        self._register_kf_bow(kf, hf)
        sel = np.flatnonzero((hf.depth > 0) & hf.valid)
        X_w = hf.xyz_c[sel]  # identity pose: camera frame == world frame
        ids = self.map.create_points_from_depth(kf, sel, X_w)
        hf.feat_mp[sel] = ids
        if self.cfg.use_lines and hf.line_valid is not None:
            line_mapping.create_or_attach_lines(self.map, kf, hf, hf.T_cw)
            if self.cfg.use_lils:
                line_mapping.create_or_attach_lils(self.map, kf, hf, hf.T_cw)
        self.ref_kf = kf
        self.state = TrackState.OK
        self.stats["kf_inserted"] += 1

    # ------------------------------------------------------------------

    def _track_fused(self, gray_d, depth_d, timestamp: float) -> HostFrame:
        """The per-frame hot path: ONE fused device dispatch against the
        device-resident snapshot + one 24-float fetch (frame_step.py)."""
        cfg = self.cfg
        if self._snap is None:
            self._rebuild_snapshot()
        out = fstep.frame_step(
            cfg, gray_d, depth_d, jnp.asarray(self.last.T_cw),
            jnp.asarray(self.velocity), cfg.tracking.motion_match_radius,
            self._snap, self._acc,
        )
        return self._finish_frame(
            out, gray_d, depth_d, timestamp, self.frame_id, self._snap_epoch
        )

    def _finish_frame(
        self, out, gray_d, depth_d, timestamp: float, frame_id: int,
        epoch: int, snap_ids=None,
    ) -> HostFrame:
        """Consume one frame_step result: fetch the summary, retry with the
        widened window (Tracking.cc:1198-1203) and the un-windowed
        reference-KF search (TrackReferenceKeyFrame, Tracking.cc:880) when
        inliers are scarce, update the state machine, and run the keyframe
        policy. ``epoch`` is the snapshot generation the dispatch used and
        ``snap_ids`` that generation's (pt, ml, il) id arrays — a frame
        from a superseded snapshot still keeps its pose and can become a
        keyframe (its matches resolve through its own (id, gen) pairs; slots
        culled — or culled AND recycled — since then fail the generation
        check), but its accumulators are dropped."""
        cfg = self.cfg
        cfg_t = cfg.tracking
        if snap_ids is None:
            snap_ids = self._snap_id_pack()
        summary = np.asarray(out.summary)
        # Retry gates: the reference demands >= 30 TrackLocalMap inliers
        # before trusting a pose (Tracking.cc:1400-1406) AND widens the
        # motion window when the FIRST (motion-model) search found < 20
        # matches (Tracking.cc:1198-1203). The second gate is load-bearing:
        # under large inter-frame motion the local-map stage can scrape
        # together >= 30 loose "inliers" around a collapsed pose (observed
        # as a ~2 m frame-1 failure), while the motion-window count is a
        # clean signal that the prediction missed.
        retry_th = max(cfg_t.min_local_inliers, cfg_t.min_track_inliers)

        def needs_retry(s):
            return (
                s[fstep.S_INLIERS] < retry_th
                or s[fstep.S_INLIERS_1] < cfg_t.min_motion_matches
            )

        if needs_retry(summary):
            # Same compiled program, widened motion window, CURRENT snapshot.
            out2 = fstep.frame_step(
                cfg, gray_d, depth_d, jnp.asarray(self.last.T_cw),
                jnp.asarray(self.velocity),
                cfg_t.motion_match_radius_wide, self._snap, self._acc,
            )
            s2 = np.asarray(out2.summary)
            if s2[fstep.S_INLIERS] > summary[fstep.S_INLIERS]:
                out, summary, epoch = out2, s2, self._snap_epoch
                snap_ids = self._snap_id_pack()
        if needs_retry(summary):
            fb = self._fallback_ref_kf(gray_d, depth_d, out)
            if fb is not None and (
                np.asarray(fb[1])[fstep.S_INLIERS]
                > summary[fstep.S_INLIERS]
            ):
                out, summary = fb
                epoch = self._snap_epoch
                snap_ids = self._snap_id_pack()

        hf = HostFrame(
            frame_id=frame_id,
            timestamp=float(timestamp),
            T_cw=np.asarray(
                summary[fstep.S_T], np.float32
            ).reshape(4, 4).copy(),
        )
        if epoch == self._snap_epoch:
            self._acc = out.acc
        n_inliers = int(summary[fstep.S_INLIERS])
        if n_inliers < cfg_t.min_track_inliers:
            if self.localization_only and self._finish_vo(hf, out, snap_ids):
                return hf
            self.state = TrackState.LOST
            self.velocity = np.eye(4, dtype=np.float32)
            self._vo_prev = None
            hf.T_cw = self.last.T_cw.copy()
            return hf

        self.state = TrackState.OK
        self.velocity = (hf.T_cw @ np.linalg.inv(self.last.T_cw)).astype(
            np.float32
        )
        if self.localization_only:
            # mbVO accounting (Tracking.cc:1280: mbVO = nmatchesMap < 10):
            # few map inliers while only-tracking means the map has drifted
            # out of view. KF insertion and every backend stage stay frozen
            # (System.cc:270-283). Keep the frame for the VO fallback.
            self._vo_mode = n_inliers < 10
            self._vo_prev = (out.fd, hf.T_cw.copy())
        elif self._need_new_keyframe(hf, summary):
            self._materialize_host_frame(hf, out, snap_ids)
            self._create_keyframe(hf)
            self._rebuild_snapshot()
        return hf

    def _finish_vo(self, hf: HostFrame, out, snap_ids) -> bool:
        """The mbVO branch of localization-only tracking
        (Tracking.cc:304-411, 1049-1162): when map inliers collapse while
        only-tracking, (a) attempt relocalization — if it succeeds it WINS
        the arbitration and clears VO mode (Tracking.cc:367-405); (b)
        otherwise keep tracking on frame-to-frame matches against the
        previous frame's depth-backed features as temporary VO landmarks,
        accepted at >= 20 matches (Tracking.cc:1289: return nmatches>20).
        Returns True if the frame survives (state OK), False -> LOST."""
        from pslam.pipeline.relocalization import relocalize
        from pslam.pipeline.track_ops import track_frame_to_frame

        cfg = self.cfg
        self._materialize_host_frame(hf, out, snap_ids)
        if relocalize(self, hf, out.fd):
            self.state = TrackState.OK
            self.velocity = np.eye(4, dtype=np.float32)
            self._vo_mode = False
            self._vo_prev = (out.fd, hf.T_cw.copy())
            self.stats["relocs"] = self.stats.get("relocs", 0) + 1
            return True
        if self._vo_prev is None:
            return False
        prev_fd, prev_T = self._vo_prev
        T_pred = (self.velocity @ self.last.T_cw).astype(np.float32)
        res = track_frame_to_frame(
            cfg.camera, jnp.asarray(T_pred), prev_fd, jnp.asarray(prev_T),
            out.fd, cfg.tracking.motion_match_radius_wide,
            cfg.orb.scale, cfg.orb.levels,
        )
        if int(res.n_inliers) < 20:
            # Fast pan: the image shift exceeded the wide window — retry
            # with pure descriptor matching (no projection window).
            from pslam.pipeline.track_ops import (
                track_frame_to_frame_unwindowed,
            )

            res = track_frame_to_frame_unwindowed(
                cfg.camera, jnp.asarray(T_pred), prev_fd,
                jnp.asarray(prev_T), out.fd, cfg.orb.scale, cfg.orb.levels,
            )
        if int(res.n_inliers) < 20:
            return False
        hf.T_cw = np.asarray(res.T_cw, np.float32).copy()
        self.state = TrackState.OK
        self.velocity = (hf.T_cw @ np.linalg.inv(self.last.T_cw)).astype(
            np.float32
        )
        self._vo_mode = True
        self._vo_prev = (out.fd, hf.T_cw.copy())
        self.stats["vo_frames"] = self.stats.get("vo_frames", 0) + 1
        return True

    def _fallback_ref_kf(self, gray_d, depth_d, out):
        """Un-windowed descriptor matching against the reference KF's points
        (TrackReferenceKeyFrame / SearchByBoW, Tracking.cc:880): recovers
        motion far outside any projection window, then re-runs the fused
        step with the recovered pose as prior. Returns (out, summary) or
        None."""
        from pslam.pipeline.track_ops import (
            track_against_points_unwindowed,
        )

        cfg = self.cfg
        ref_mp = self.map.kf_feat_mp[self.ref_kf]
        ref_sel = ref_mp[ref_mp >= 0]
        pts_ref = self._point_set(ref_sel, cap=cfg.orb.capacity)
        res = track_against_points_unwindowed(
            cfg.camera, jnp.asarray(self.last.T_cw), pts_ref, out.fd,
            cfg.orb.scale, cfg.orb.levels,
        )
        if int(res.n_inliers) < cfg.tracking.min_track_inliers:
            return None
        T_fb = np.asarray(res.T_cw)
        vel_fb = (T_fb @ np.linalg.inv(self.last.T_cw)).astype(np.float32)
        out2 = fstep.frame_step(
            cfg, gray_d, depth_d, jnp.asarray(self.last.T_cw),
            jnp.asarray(vel_fb), cfg.tracking.motion_match_radius,
            self._snap, self._acc,
        )
        return out2, np.asarray(out2.summary)

    def _materialize_host_frame(self, hf: HostFrame, out, snap_ids=None):
        """Fetch the frame's feature arrays + associations from the device
        in ONE batched transfer (keyframe insertion only — Frame arrays
        never cross to the host on ordinary frames). ``snap_ids`` are the
        (id, gen) arrays of the snapshot the frame was DISPATCHED against
        (may be one epoch behind in pipelined mode); associations to
        landmarks culled since then are masked by validity, and associations
        to slots culled AND recycled are masked by the generation check."""
        m_ = self.map
        if snap_ids is None:
            snap_ids = self._snap_id_pack()
        pt_ids_s, ml_ids_s, il_ids_s, pt_gen_s, ml_gen_s, il_gen_s = snap_ids
        fd = out.fd
        use_lines = self.cfg.use_lines and out.fl is not None
        pack = [fd.uv, fd.ur, fd.depth, fd.xyz_c, fd.level, fd.angle,
                fd.desc, fd.valid, out.match_point, out.inlier]
        if use_lines:
            fl = out.fl
            pack += [fl.sp, fl.ep, fl.desc, fl.valid, fl.p3s, fl.p3e,
                     fl.ok3d, out.line_match, out.lil_match]
        got = jax.device_get(tuple(pack))
        (hf.uv, hf.ur, hf.depth, hf.xyz_c, hf.level, hf.angle, hf.desc,
         hf.valid, mp, inl) = got[:10]
        hf.feat_mp = np.full(len(hf.valid), -1, np.int32)
        n = len(pt_ids_s)
        good = (
            (mp[:n] >= 0) & inl[:n] & m_.mp_valid[pt_ids_s]
            & (m_.mp_gen[pt_ids_s] == pt_gen_s)
        )
        hf.feat_mp[mp[:n][good]] = pt_ids_s[good]
        if use_lines:
            (hf.line_sp, hf.line_ep, hf.line_desc, hf.line_valid,
             hf.line_p3s, hf.line_p3e, hf.line_ok3d, lm, qm) = got[10:]
            hf.line_ml = np.full(len(hf.line_valid), -1, np.int32)
            # Host mirror of the LIL features (the line_mapping bookkeeping
            # reads every field; one batched fetch beats ~11 leaf fetches).
            hf.lil = jax.device_get(fl.lil)
            hf.lil_il = np.full(self.cfg.caps.frame_lils, -1, np.int32)
            nl = len(ml_ids_s)
            src = np.flatnonzero(
                (lm[:nl] >= 0) & m_.ml_valid[ml_ids_s]
                & (m_.ml_gen[ml_ids_s] == ml_gen_s)
            )
            hf.line_ml[lm[:nl][src]] = ml_ids_s[src]
            if self.cfg.use_lils:
                nq = len(il_ids_s)
                ok = (qm >= 0) & (qm < nq)
                ok[ok] = m_.il_valid[il_ids_s[qm[ok]]] & (
                    m_.il_gen[il_ids_s[qm[ok]]] == il_gen_s[qm[ok]]
                )
                hf.lil_il[ok] = il_ids_s[qm[ok]]

    def _need_new_keyframe(self, hf: HostFrame, summary) -> bool:
        """NeedNewKeyFrame (Tracking.cc:1410-1515), RGB-D branch, computed
        from the device summary counts."""
        t = self.cfg.tracking
        frames_since_kf = hf.frame_id - int(
            self.map.kf_frame_id[self.map.last_kf]
        )
        ref_tracked = int((self.map.kf_feat_mp[self.ref_kf] >= 0).sum())
        n_inliers = int(summary[fstep.S_INLIERS])
        tracked_close = int(summary[fstep.S_TRACKED_CLOSE])
        untracked_close = int(summary[fstep.S_UNTRACKED_CLOSE])
        # Close points tracked vs close points available (Tracking.cc:1452).
        need_close = (tracked_close < 100) and (untracked_close > 70)

        c1 = frames_since_kf >= t.kf_max_interval
        c2 = n_inliers < ref_tracked * t.kf_min_inlier_ratio or need_close
        c3 = n_inliers > 15
        return (c1 or c2) and c3 and frames_since_kf >= t.kf_min_interval

    # ------------------------------------------------------------------
    # Snapshot lifecycle

    def _rebuild_snapshot(self):
        """Upload a fresh tracker view of the map (keyframe events only)."""
        self._fold_acc()
        self._snap_epoch += 1
        self._fresh_acc = True
        cfg = self.cfg
        m = self.map
        local_kfs = self._local_keyframes()
        pt_ids = m.local_map_points(local_kfs, cfg.caps.local_points)
        ml_ids = np.zeros(0, np.int64)
        il_ids = np.zeros(0, np.int64)
        if cfg.use_lines:
            ml_ids = line_mapping.local_map_lines(
                m, local_kfs, cfg.caps.local_lines
            )
            if cfg.use_lils:
                il_ids = np.flatnonzero(m.il_valid)[: cfg.caps.local_lils]
        self._snap = fstep.build_snapshot(m, cfg, pt_ids, ml_ids, il_ids)
        self._snap_pt_ids = np.asarray(pt_ids, np.int64)
        self._snap_ml_ids = np.asarray(ml_ids, np.int64)
        self._snap_il_ids = np.asarray(il_ids, np.int64)
        self._snap_pt_gen = m.mp_gen[self._snap_pt_ids].copy()
        self._snap_ml_gen = m.ml_gen[self._snap_ml_ids].copy()
        self._snap_il_gen = m.il_gen[self._snap_il_ids].copy()
        self._acc = fstep.make_acc(cfg)

    def _snap_id_pack(self):
        """The (ids, gens) identity of the CURRENT snapshot — what a frame
        dispatched against it needs to resolve matches later, even if the
        snapshot has been superseded and slots recycled in the meantime."""
        return (
            self._snap_pt_ids, self._snap_ml_ids, self._snap_il_ids,
            self._snap_pt_gen, self._snap_ml_gen, self._snap_il_gen,
        )

    def _fold_acc(self):
        """Fold the device found/visible accumulators into the host map
        (must run BEFORE any landmark mutation, while the snapshot ids are
        still live)."""
        if self._acc is None or self._snap is None:
            return
        a = jax.device_get(self._acc)
        m = self.map
        n = len(self._snap_pt_ids)
        if n:
            # Gen guard: don't credit counters of a slot recycled since the
            # snapshot was built (it holds a different landmark now).
            ok = m.mp_gen[self._snap_pt_ids] == self._snap_pt_gen
            ids = self._snap_pt_ids[ok]
            np.add.at(m.mp_visible, ids, a.pt_vis[:n][ok])
            np.add.at(m.mp_found, ids, a.pt_found[:n][ok])
        nl = len(self._snap_ml_ids)
        if nl:
            ok = m.ml_gen[self._snap_ml_ids] == self._snap_ml_gen
            ids = self._snap_ml_ids[ok]
            np.add.at(m.ml_visible, ids, a.ml_vis[:nl][ok])
            np.add.at(m.ml_found, ids, a.ml_found[:nl][ok])
        nq = len(self._snap_il_ids)
        if nq:
            # AddFrameObservation (Map.cc:268 -> insectline.cc:39-43).
            ok = m.il_gen[self._snap_il_ids] == self._snap_il_gen
            np.add.at(
                m.il_frame_obs, self._snap_il_ids[ok], a.il_obs[:nq][ok]
            )
        self._acc = None

    def _invalidate_snapshot(self, fold: bool = True):
        if fold:
            self._fold_acc()
        self._snap = None
        self._acc = None

    def _point_set(self, mp_ids, cap: int) -> PointSet:
        """Gather a device PointSet snapshot for the given map-point ids."""
        return fstep.build_point_set(self.map, np.asarray(mp_ids, np.int64), cap)

    def _local_keyframes(self):
        """Reference KF + best covisible neighbours (UpdateLocalKeyFrames,
        Tracking.cc:1905-2029, capped at 80)."""
        base = self.ref_kf
        covis = self.map.best_covisible(base, 79)
        ids = np.unique(np.concatenate([[base], covis]))
        return ids

    def _create_keyframe(self, hf: HostFrame):
        """CreateNewKeyFrame (Tracking.cc:1516-1605): insert KF, create new
        map points from depth for unmatched close features, run the backend."""
        # Commit the previous keyframe's (still in-flight) local BA and
        # backend (triangulation + fuse) before touching the map (the
        # tracker consumed the pre-BA snapshot in the meantime — SURVEY
        # §7.2 async dispatch replacing the LocalMapping thread,
        # System.cc:86-113).
        self._fold_acc()
        self._commit_pending_ba()
        self._commit_pending_backend()
        self._evict_for_capacity()
        kf = self.map.add_keyframe(
            hf.frame_id, hf.timestamp, hf.T_cw, hf.uv, hf.ur, hf.level, hf.angle,
            hf.desc, hf.valid, hf.depth, hf.feat_mp,
        )
        self._register_kf_bow(kf, hf)
        self.ref_kf = kf
        self.stats["kf_inserted"] += 1

        # New points from depth: unmatched features sorted by depth, close
        # ones first, at least 100 (Tracking.cc:1545-1599).
        cand = np.flatnonzero((hf.feat_mp < 0) & (hf.depth > 0) & hf.valid)
        if len(cand):
            order = np.argsort(hf.depth[cand])
            cand = cand[order]
            close = hf.depth[cand] < self.cfg.th_depth
            n_take = max(int(close.sum()), min(100, len(cand)))
            n_take = min(n_take, self.cfg.tracking.max_new_points_per_kf)
            sel = cand[:n_take]
            T_wc = np.linalg.inv(hf.T_cw)
            X_w = (hf.xyz_c[sel] @ T_wc[:3, :3].T) + T_wc[:3, 3]
            ids = self.map.create_points_from_depth(kf, sel, X_w.astype(np.float32))
            hf.feat_mp[sel] = ids

        # Lines & structural lines onto the new KF.
        if self.cfg.use_lines and hf.line_valid is not None:
            line_mapping.create_or_attach_lines(self.map, kf, hf, hf.T_cw)
            if self.cfg.use_lils:
                line_mapping.create_or_attach_lils(self.map, kf, hf, hf.T_cw)
                self.stats["lils_culled"] = self.stats.get(
                    "lils_culled", 0
                ) + line_mapping.cull_lils_by_quality(self.map, self.cfg)
            self.stats["culled"] += line_mapping.cull_lines(self.map, self.cfg)

        # Backend (LocalMapping::Run order, LocalMapping.cc:47-120): point
        # culling, epipolar triangulation of new points, line triangulation,
        # neighbour fuse, local BA, keyframe culling. The device stages
        # (point triangulation + point fuse) are DISPATCHED here and
        # committed at the next keyframe event (the line stages are pure
        # host numpy and run inline): the keyframe's frame pays dispatch
        # latency only, never a device round trip.
        self.stats["culled"] += local_mapping.cull_points(self.map, self.cfg)
        if self.cfg.use_lines and hf.line_valid is not None:
            self.stats["lines_triangulated"] = self.stats.get(
                "lines_triangulated", 0
            ) + line_mapping.create_new_map_lines(self.map, kf, self.cfg)
            self.stats["lines_fused"] = self.stats.get(
                "lines_fused", 0
            ) + line_mapping.fuse_lines_in_neighbors(self.map, kf, self.cfg)
            row = self.map.kf_line_ml[kf]
            self.map.update_line_stats(np.unique(row[row >= 0]))
        self._dispatch_backend(kf)
        self.map.update_point_stats(
            np.unique(self.map.kf_feat_mp[kf][self.map.kf_feat_mp[kf] >= 0])
        )
        self._run_local_ba(kf)
        self._cull_keyframes(kf)

        # Loop closing on the freshly inserted KF (LoopClosing::Run would
        # poll its queue; here it runs synchronously after local BA).
        if self.loop_closer is not None:
            self.loop_closer.on_new_keyframe(kf)

    def _evict_for_capacity(self):
        """Graceful keyframe-capacity handling (VERDICT r3 item 5): when the
        KF table is full and the redundancy-based culling could not keep up
        (e.g. a low-motion corridor), evict the most covisibility-redundant
        unprotected keyframe — with full bookkeeping (trajectory retarget,
        BoW erase) — instead of crashing."""
        m = self.map
        if m.n_kf < m.kf_valid.shape[0]:
            return
        if (~m.kf_valid[: m.n_kf]).any():
            return
        protect = {0, self.ref_kf, int(m.last_kf)}
        if self.loop_closer is not None:
            for a, b in self.loop_closer.loop_edges:
                protect.add(a)
                protect.add(b)
        live = np.asarray(
            [k for k in np.flatnonzero(m.kf_valid) if k not in protect]
        )
        if len(live) == 0:
            # Every unprotected KF holds a loop edge: drop the loop edges of
            # the most-redundant one rather than letting add_keyframe hit an
            # un-bookkept map-level eviction (ADVICE r4: the map backstop now
            # raises instead of corrupting trajectories silently).
            hard_protect = {0, self.ref_kf, int(m.last_kf)}
            live = np.asarray(
                [k for k in np.flatnonzero(m.kf_valid) if k not in hard_protect]
            )
            if len(live) == 0:
                return
            victim = int(live[np.argmax(m.covis[live, : m.n_kf].max(axis=1))])
            if self.loop_closer is not None:
                self.loop_closer.loop_edges = [
                    (a, b)
                    for a, b in self.loop_closer.loop_edges
                    if a != victim and b != victim
                ]
            self._retarget_trajectory(victim)
            if self.kf_db is not None:
                self.kf_db.erase(victim)
            m.erase_keyframe(victim)
            self.stats["kf_evicted"] = self.stats.get("kf_evicted", 0) + 1
            return
        victim = int(live[np.argmax(m.covis[live, : m.n_kf].max(axis=1))])
        import logging

        logging.getLogger(__name__).warning(
            "keyframe capacity full: evicting most-redundant KF %d", victim
        )
        self._retarget_trajectory(victim)
        if self.kf_db is not None:
            self.kf_db.erase(victim)
        m.erase_keyframe(victim)
        self.stats["kf_evicted"] = self.stats.get("kf_evicted", 0) + 1

    def _cull_keyframes(self, kf: int):
        """KeyFrameCulling + the bookkeeping the map can't do itself:
        re-target trajectory rows that referenced the victim, drop it from
        the BoW database (KeyFrame::SetBadFlag touches both)."""
        protect = {self.ref_kf}
        if self.loop_closer is not None:
            # KFs holding loop edges are never erased (the reference's
            # mspLoopEdges check in KeyFrame::SetBadFlag).
            for a, b in self.loop_closer.loop_edges:
                protect.add(a)
                protect.add(b)
        victims = local_mapping.cull_keyframes(
            self.map, kf, self.cfg, protect=protect
        )
        for k in victims:
            self._retarget_trajectory(k)
            if self.kf_db is not None:
                self.kf_db.erase(k)
            self.map.erase_keyframe(k)
        self.stats["kf_culled"] = self.stats.get("kf_culled", 0) + len(victims)

    def _retarget_trajectory(self, k: int):
        """Re-reference trajectory rows pointing at KF ``k`` to its best
        covisible neighbour before the slot is erased/recycled (the
        reference chains mTcp to the parent on SetBadFlag,
        KeyFrame.cc:533-608)."""
        cov = self.map.best_covisible(k, 1)
        parent = int(cov[0]) if len(cov) else int(self.map.last_kf)
        if parent == k:
            parent = -1
        T_k = self.map.kf_pose[k]
        if parent >= 0:
            T_fix = (T_k @ np.linalg.inv(self.map.kf_pose[parent])).astype(
                np.float32
            )
        self.trajectory = [
            (ts, T_rel, ref)
            if ref != k
            else (
                (ts, (T_rel @ T_fix).astype(np.float32), parent)
                if parent >= 0
                else (ts, (T_rel @ T_k).astype(np.float32), -1)
            )
            for ts, T_rel, ref in self.trajectory
        ]

    def _run_local_ba(self, kf_idx: int):
        """Dispatch the local BA solve to the device WITHOUT blocking (the
        reference overlaps LocalMapping's BA with tracking on a thread,
        System.cc:86-113; here JAX async dispatch provides the overlap).
        The result is committed at the next keyframe event
        (_commit_pending_ba); a loop correction discards it instead
        (_interrupt_ba == mbAbortBA, LocalMapping.cc:984-986)."""
        if self.map.n_kf < 3:
            return
        out = local_mapping.assemble_local_ba(self.map, kf_idx, self.cfg)
        if out is None:
            return
        prob, cam_ids, pt_ids, e_feat, n_e = out

        lil_pack = None
        if self.cfg.use_lines and self.cfg.use_lils:
            lil_pack = line_mapping.assemble_lil_edges(self.map, cam_ids, self.cfg)
        if lil_pack is not None:
            lil_state, lil_valid, ledges, il_ids = lil_pack
            if self.cfg.distributed and len(jax.devices()) > 1:
                # Edge-sharded composite-error BA (VERDICT r3 item 4): the
                # flagship LIL solve rides the same mesh as the point BA.
                from pslam.parallel.sharded_ba import (
                    make_ba_mesh,
                    sharded_local_bundle_adjustment_lil,
                )

                T_opt, X_opt, lil_opt, in_p, in_l = (
                    sharded_local_bundle_adjustment_lil(
                        self.cfg.camera, prob, jnp.asarray(lil_state),
                        jnp.asarray(lil_valid), ledges,
                        self.cfg.caps.ba_free, make_ba_mesh(),
                    )
                )
            else:
                T_opt, X_opt, lil_opt, in_p, in_l = (
                    local_bundle_adjustment_lil(
                        self.cfg.camera, prob, jnp.asarray(lil_state),
                        jnp.asarray(lil_valid), ledges,
                        self.cfg.caps.ba_free,
                    )
                )
            result = (T_opt, X_opt, in_p, None)
        elif self.cfg.distributed and len(jax.devices()) > 1:
            # Edge-sharded Schur assembly over the device mesh
            # (parallel/sharded_ba.py); caps.ba_edges is a power of two, so
            # the fixed-capacity edge arrays always divide the mesh.
            from pslam.parallel.sharded_ba import (
                make_ba_mesh,
                sharded_local_bundle_adjustment,
            )

            result = sharded_local_bundle_adjustment(
                self.cfg.camera, prob, self.cfg.caps.ba_free, make_ba_mesh()
            )
            lil_opt = il_ids = None
        else:
            result = local_bundle_adjustment(
                self.cfg.camera, prob, self.cfg.caps.ba_free
            )
            lil_opt = il_ids = None
        if lil_pack is None:
            lil_opt = il_ids = None
        self._pending_ba = {
            "result": result,
            "lil_opt": lil_opt,
            "il_ids": il_ids,
            "cam_ids": cam_ids,
            "pt_ids": pt_ids,
            "e_feat": e_feat,
            "n_e": n_e,
            "free_slot": np.asarray(prob.free_slot),
        }

    def _commit_pending_ba(self):
        """Fetch + write back the in-flight local BA (if any)."""
        p = self._pending_ba
        if p is None:
            return
        self._pending_ba = None
        # One batched transfer for the whole result.
        p["result"], p["lil_opt"] = jax.device_get(
            (p["result"], p["lil_opt"])
        )
        if p["lil_opt"] is not None:
            # Write back LIL structures + refresh plane offsets (d = -mean
            # n.p; the rigid-translation update leaves n unchanged).
            lil_opt = np.asarray(p["lil_opt"])
            il_ids = p["il_ids"]
            sel = il_ids >= 0
            ids = il_ids[sel]
            alive = self.map.il_valid[ids]
            ids, st = ids[alive], lil_opt[sel][alive]
            self.map.il_state[ids] = st
            n = self.map.il_plane[ids, :3]
            pts = st.reshape(-1, 5, 3)
            d = -np.einsum("qj,qpj->q", n, pts) / 5.0
            flip = d < 0
            pl = np.concatenate([np.where(flip[:, None], -n, n),
                                 np.abs(d)[:, None]], axis=1)
            self.map.il_plane[ids] = pl.astype(np.float32)
        local_mapping.write_back_ba(
            self.map, p["result"], p["cam_ids"], p["pt_ids"], p["e_feat"],
            p["n_e"], p["free_slot"],
        )
        self.stats["ba_runs"] += 1

    def _dispatch_backend(self, kf: int):
        """Dispatch the new KF's device backend (epipolar triangulation +
        neighbour fuse) without fetching; committed at the next KF event."""
        from pslam.pipeline import local_mapping as lm

        self._pending_backend = {
            "tri": lm.dispatch_triangulation(self.map, kf, self.cfg),
            "fuse": lm.dispatch_fuse(self.map, kf, self.cfg),
        }

    def _commit_pending_backend(self):
        p = self._pending_backend
        if p is None:
            return
        self._pending_backend = None
        from pslam.pipeline import local_mapping as lm

        if p["tri"] is not None:
            self.stats["triangulated"] = self.stats.get(
                "triangulated", 0
            ) + lm.commit_triangulation(self.map, p["tri"], self.cfg)
        if p["fuse"] is not None:
            self.stats["fused"] = self.stats.get(
                "fused", 0
            ) + lm.commit_fuse(self.map, p["fuse"], self.cfg)

    def _interrupt_ba(self):
        """Discard the in-flight local BA AND backend (InterruptBA /
        mbAbortBA, LocalMapping.cc:984-986): called by the loop closer right
        before a correction rewrites the poses the solves were based on."""
        self._pending_ba = None
        self._pending_backend = None

    # ------------------------------------------------------------------

    def _register_kf_bow(self, kf: int, hf: HostFrame):
        """Compute + store the new KF's BoW (KeyFrame::ComputeBoW +
        KeyFrameDatabase::add)."""
        if self.kf_db is None:
            return
        b, w, nd = self.kf_db.compute_bow(hf.desc, hf.valid)
        self.kf_db.add(kf, b, w, nd)

    def reset(self):
        """System::Reset (System.cc:294) / Tracking::Reset (Tracking.cc:2195):
        clear map, database, trajectory bookkeeping keeps accumulating."""
        vocab = self.kf_db.vocab if self.kf_db is not None else None
        self._pending_ba = None
        self._pending_backend = None
        self._inflight = None
        self._invalidate_snapshot(fold=False)
        # Freeze prior rows to absolute poses — their reference KFs are about
        # to be destroyed with the map.
        self.trajectory = [
            (ts, self._abs_pose(T_rel, ref), -1)
            for ts, T_rel, ref in self.trajectory
        ]
        self.map = MapState(self.cfg)
        if self.kf_db is not None:
            from pslam.pipeline.keyframe_db import KeyFrameDatabase

            self.kf_db = KeyFrameDatabase(
                vocab, self.cfg.caps.max_keyframes, self.cfg.orb.capacity
            )
        if self.loop_closer is not None:
            from pslam.pipeline.loop_closing import LoopCloser

            self.loop_closer = LoopCloser(self)
        self.state = TrackState.NOT_INITIALIZED
        self.velocity = np.eye(4, dtype=np.float32)
        self.ref_kf = 0
        self.stats["resets"] = self.stats.get("resets", 0) + 1

    def activate_localization_mode(self):
        """Freeze the backend; keep tracking against the current map
        (System::ActivateLocalizationMode, System.cc:270-276). The map,
        BoW database, and loop closer stop changing; relocalization remains
        available for blackout recovery."""
        self.flush()
        self.localization_only = True

    def deactivate_localization_mode(self):
        """Resume full SLAM (System::DeactivateLocalizationMode,
        System.cc:277-283)."""
        self.localization_only = False
        self._vo_mode = False
        self._vo_prev = None

    def flush(self):
        """Commit any in-flight device work (async local BA, async KF
        backend, found/visible accumulators) into the host map. Call before
        reading map state externally (trajectory save, checkpoint,
        evaluation)."""
        self._fold_acc()
        self._commit_pending_ba()
        self._commit_pending_backend()
        if self._snap is not None and self._acc is None:
            self._acc = fstep.make_acc(self.cfg)

    def _abs_pose(self, T_rel: np.ndarray, ref_kf: int) -> np.ndarray:
        """Chain a relative row against the current (possibly loop-corrected)
        reference-KF pose (System.cc:345-365)."""
        if ref_kf < 0:
            return T_rel
        return (T_rel @ self.map.kf_pose[ref_kf]).astype(np.float32)

    @staticmethod
    def _write_tum_row(f, ts: float, T_cw: np.ndarray):
        from pslam.geometry.lie import rotation_to_quaternion

        import jax.numpy as jnp_

        R = T_cw[:3, :3]
        t = T_cw[:3, 3]
        C = -R.T @ t
        q = np.asarray(rotation_to_quaternion(jnp_.asarray(R.T)))
        f.write(
            f"{ts:.6f} {C[0]:.7f} {C[1]:.7f} {C[2]:.7f} "
            f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n"
        )

    def save_trajectory_tum(self, path: str):
        """TUM-format trajectory (System::SaveTrajectoryTUM, System.cc:323)."""
        self.flush()
        with open(path, "w") as f:
            for ts, T_rel, ref in self.trajectory:
                self._write_tum_row(f, ts, self._abs_pose(T_rel, ref))

    def save_keyframe_trajectory_tum(self, path: str):
        """TUM-format keyframe trajectory (SaveKeyFrameTrajectoryTUM,
        System.cc:384)."""
        self.flush()
        m = self.map
        # Slot order is not temporal once culled slots are recycled; emit
        # rows in timestamp order for downstream evaluation tools.
        ks = np.flatnonzero(m.kf_valid[: m.n_kf])
        ks = ks[np.argsort(m.kf_timestamp[ks], kind="stable")]
        with open(path, "w") as f:
            for k in ks:
                self._write_tum_row(f, float(m.kf_timestamp[k]), m.kf_pose[k])

    def save_trajectory_kitti(self, path: str):
        """KITTI-format trajectory: row-major 3x4 of T_wc
        (System::SaveTrajectoryKITTI, System.cc:412-441)."""
        self.flush()
        with open(path, "w") as f:
            for ts, T_rel, ref in self.trajectory:
                T = self._abs_pose(T_rel, ref)
                R = T[:3, :3].T
                C = -R @ T[:3, 3]
                vals = np.c_[R, C].reshape(-1)
                f.write(" ".join(f"{v:.9e}" for v in vals) + "\n")

    @property
    def poses(self):
        self.flush()
        return np.stack(
            [self._abs_pose(T_rel, ref) for _, T_rel, ref in self.trajectory]
        )
