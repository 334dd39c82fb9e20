"""Loop closing: detection, Sim3 computation, loop correction, global BA.

Re-implements LoopClosing (reference src/LoopClosing.cc) — which the
reference ships DISABLED (`while(0)`, LoopClosing.cc:61) — and enables it,
as BASELINE config 4 requires:

- ``detect_loop``: BoW candidates below the covisibility min-score with
  3-consecutive consistency groups (LoopClosing.cc:103-229, th=3 at :43);
- ``compute_sim3``: SearchByBoW matches -> fixed-budget Sim3 RANSAC
  (solver/horn.py) -> optimize_sim3 (solver/sim3_graph.py) -> guided
  projection matching, accept at >= 40 matches (LoopClosing.cc:231-401);
- ``correct_loop``: propagate the corrected Sim3 over the current covisible
  group, retransform their landmarks, fuse duplicates, optimize the
  essential graph with the loop keyframe fixed, then global BA
  (LoopClosing.cc:402-615 + RunGlobalBundleAdjustment 645-750; the
  reference's async GBA thread becomes a synchronous call on the
  device).

For RGB-D the Sim3 scale is fixed (mbFixScale=true for non-mono sensors,
System.cc:95 ctor arg), matching the reference.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from pslam.geometry import Camera, in_image
from pslam.geometry.camera import project
from pslam.geometry.lie import (
    Sim3,
    sim3_compose,
    sim3_from_se3,
    sim3_inverse,
    sim3_to_se3,
    sim3_transform_points,
)
from pslam.models.map_state import COVIS_TH
from pslam.ops.bow import bow_group_mask, score_l1
from pslam.ops.match import (
    TH_LOW,
    hamming_matrix,
    mutual_nn_match,
    rotation_consistency_mask,
    window_mask,
)
from pslam.solver.horn import sim3_ransac
from pslam.solver.sim3_graph import (
    PoseGraphProblem,
    optimize_essential_graph,
    optimize_sim3,
)

CONSISTENCY_TH = 3  # mnCovisibilityConsistencyTh (LoopClosing.cc:43)
MIN_BOW_MATCHES = 20  # LoopClosing.cc:282
MIN_SIM3_INLIERS = 20  # LoopClosing.cc:333 (OptimizeSim3 >= 20)
MIN_TOTAL_MATCHES = 40  # LoopClosing.cc:392
ESSENTIAL_MIN_WEIGHT = 100  # minFeat covis edges (Optimizer.cc:2673)


# ---------------------------------------------------------------------------
# Device programs
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=())
def _match_kf_bow(desc1, angle1, node1, ok1, desc2, angle2, node2, ok2):
    """SearchByBoW between two keyframes' feature sets (ORBmatcher.cc:522):
    bucket-restricted mutual NN with rotation consistency. Returns idx (N1,)
    -> feature in KF2 or -1."""
    dist = hamming_matrix(desc1, desc2)
    bucket = bow_group_mask(node1, node2)
    idx, _ = mutual_nn_match(
        dist, valid_a=ok1, valid_b=ok2, max_dist=TH_LOW, ratio=0.75,
        extra_mask=bucket,
    )
    fi = jnp.maximum(idx, 0)
    keep = rotation_consistency_mask(angle1, angle2[fi], idx >= 0)
    return jnp.where(keep, idx, -1)


@partial(jax.jit, static_argnames=("cam",))
def _match_by_projection_sim3(
    cam: Camera, Scw: Sim3, pos_w, desc_p, ok_p, f_uv, f_desc, f_angle, f_ok,
    radius,
):
    """ORBmatcher::SearchByProjection with a Sim3 world->cam (ORBmatcher.cc:290):
    project candidate world points through Scw into the current KF's features,
    windowed Hamming NN. Returns idx (P,) -> feature or -1."""
    Xc = sim3_transform_points(Scw, pos_w)
    uv = project(cam, Xc)
    vis = ok_p & (Xc[:, 2] > 0.05) & in_image(cam, uv, margin=1.0)
    box = window_mask(uv, f_uv, radius)
    dist = hamming_matrix(desc_p, f_desc)
    idx, _ = mutual_nn_match(
        dist, valid_a=vis, valid_b=f_ok, max_dist=TH_LOW, ratio=0.99,
        extra_mask=box,
    )
    return idx


# ---------------------------------------------------------------------------
# LoopCloser
# ---------------------------------------------------------------------------


class LoopCloser:
    def __init__(self, system):
        self.sys = system
        # Consistency groups hold KF *sequence numbers* (KeyFrame::mnId), not
        # slot indices: slots are recycled after culling, and a recycled slot
        # would alias a stale group member onto an unrelated new KF.
        self.consistent_groups: list[tuple[set, int]] = []
        self.last_loop_seq = -100  # seq of the last accepted loop KF
        self.loop_edges: list[tuple[int, int]] = []  # (kf, loop_kf) accepted
        self.stats = {"detected": 0, "closed": 0, "gba_runs": 0}

    # -- DetectLoop (LoopClosing.cc:103-229) ---------------------------------

    def detect_loop(self, kf: int) -> list[int]:
        m = self.sys.map
        db = self.sys.kf_db
        # Gate on the monotonic insertion sequence (reference compares mnId,
        # LoopClosing.cc:110), never the recyclable slot index.
        if (
            db is None
            or m.kf_seq[kf] < self.last_loop_seq + 10
            or int(m.kf_valid.sum()) < 10
        ):
            return []
        covis = m.covisible_kfs(kf)
        if len(covis) == 0:
            return []
        scores = np.asarray(
            score_l1(jnp.asarray(db.bow[kf]), jnp.asarray(db.bow[covis]))
        )
        min_score = float(scores.min())
        cands = db.detect_loop_candidates(kf, min_score, m)
        if len(cands) == 0:
            self.consistent_groups = []
            return []
        # Consistency groups (LoopClosing.cc:152-211).
        enough = []
        current_groups: list[tuple[set, int]] = []
        for c in cands:
            group = {int(m.kf_seq[c])} | {
                int(m.kf_seq[j]) for j in m.covisible_kfs(int(c))
            }
            best_consistency = 0
            for prev_group, n in self.consistent_groups:
                if group & prev_group:
                    best_consistency = max(best_consistency, n + 1)
            current_groups.append((group, best_consistency))
            if best_consistency >= CONSISTENCY_TH:
                enough.append(int(c))
        self.consistent_groups = current_groups
        return enough

    # -- ComputeSim3 (LoopClosing.cc:231-401) --------------------------------

    def compute_sim3(self, kf: int, candidates: list[int]):
        """Returns (loop_kf, Scw_corrected (Sim3), loop_mp_ids (P,)) or None.
        loop_mp_ids = map points of the loop neighborhood used for fusion."""
        sys_, m = self.sys, self.sys.map
        cfg = sys_.cfg
        db = sys_.kf_db
        sigma2 = np.asarray(
            [(cfg.orb.scale**l) ** 2 for l in range(cfg.orb.levels)],
            np.float32,
        )
        for rank, cand in enumerate(candidates):
            idx = np.asarray(
                _match_kf_bow(
                    jnp.asarray(m.kf_desc[kf]), jnp.asarray(m.kf_angle[kf]),
                    jnp.asarray(db.node[kf]),
                    jnp.asarray(
                        (m.kf_feat_mp[kf] >= 0)
                        & m.mp_valid[np.maximum(m.kf_feat_mp[kf], 0)]
                    ),
                    jnp.asarray(m.kf_desc[cand]), jnp.asarray(m.kf_angle[cand]),
                    jnp.asarray(db.node[cand]),
                    jnp.asarray(
                        (m.kf_feat_mp[cand] >= 0)
                        & m.mp_valid[np.maximum(m.kf_feat_mp[cand], 0)]
                    ),
                )
            )
            pairs = np.flatnonzero(idx >= 0)
            if len(pairs) < MIN_BOW_MATCHES:
                continue
            f1 = pairs
            f2 = idx[pairs]
            mp1 = m.kf_feat_mp[kf, f1]
            mp2 = m.kf_feat_mp[cand, f2]

            # Camera-frame landmark positions for the Horn RANSAC.
            T1 = m.kf_pose[kf]
            T2 = m.kf_pose[cand]
            X1 = m.mp_pos[mp1] @ T1[:3, :3].T + T1[:3, 3]
            X2 = m.mp_pos[mp2] @ T2[:3, :3].T + T2[:3, 3]
            uv1 = m.kf_uv[kf, f1]
            uv2 = m.kf_uv[cand, f2]
            is2_1 = 1.0 / sigma2[np.clip(m.kf_level[kf, f1], 0, len(sigma2) - 1)]
            is2_2 = 1.0 / sigma2[np.clip(m.kf_level[cand, f2], 0, len(sigma2) - 1)]

            # Fixed-capacity padding (one compiled shape for every loop
            # attempt; dynamic N would recompile the RANSAC per call).
            CAP = 512
            n = min(len(f1), CAP)

            def pad(a, width=CAP, dims=None):
                shp = (width,) + a.shape[1:]
                out = np.zeros(shp, np.float32)
                out[:n] = a[:n]
                return jnp.asarray(out)

            vmask = jnp.asarray(np.arange(CAP) < n)
            r = sim3_ransac(
                cfg.camera, pad(X1), pad(X2), pad(uv1), pad(uv2),
                pad(is2_1), pad(is2_2), vmask,
                jax.random.PRNGKey(kf * 977 + rank),
                fix_scale=True,  # RGB-D (System.cc:95)
            )
            if int(r.n_inliers) < MIN_SIM3_INLIERS:
                continue
            g12 = Sim3(s=r.s12, R=r.R12, t=r.t12)  # cam2(cand) -> cam1(kf)
            res = optimize_sim3(
                cfg.camera, g12, pad(X1), pad(X2), pad(uv1), pad(uv2),
                pad(is2_1), pad(is2_2), r.inlier & vmask,
                fix_scale=True,
            )
            if int(res.n_inliers) < MIN_SIM3_INLIERS:
                continue

            # Corrected current-KF Sim3: Scw = g12 o S(cand world->cam).
            S2w = sim3_from_se3(jnp.asarray(T2.astype(np.float32)))
            Scw = sim3_compose(res.g12, S2w)

            # Guided projection matching against the loop neighborhood's map
            # points (SearchByProjection, LoopClosing.cc:373-395).
            hood = np.unique(
                np.r_[[cand], m.covisible_kfs(cand)].astype(np.int64)
            )
            mp_ids = m.local_map_points(hood, cfg.caps.local_points)
            if len(mp_ids) == 0:
                continue
            P = cfg.caps.local_points
            pos = np.zeros((P, 3), np.float32)
            desc = np.zeros((P, 32), np.uint8)
            okp = np.zeros(P, bool)
            pos[: len(mp_ids)] = m.mp_pos[mp_ids]
            desc[: len(mp_ids)] = m.mp_desc[mp_ids]
            okp[: len(mp_ids)] = True
            pidx = np.asarray(
                _match_by_projection_sim3(
                    cfg.camera, Scw, jnp.asarray(pos), jnp.asarray(desc),
                    jnp.asarray(okp), jnp.asarray(m.kf_uv[kf]),
                    jnp.asarray(m.kf_desc[kf]), jnp.asarray(m.kf_angle[kf]),
                    jnp.asarray(m.kf_feat_valid[kf]), 8.0,
                )
            )
            n_total = int((pidx[: len(mp_ids)] >= 0).sum())
            if n_total < MIN_TOTAL_MATCHES:
                continue

            # Metric 3D-3D refinement of Scw (RGB-D redesign): loop
            # neighbourhoods are often plane-dominant, and reprojection-only
            # Sim3 optimization slides along the homography-ambiguity
            # valley of a wall (observed: constraint error >> drift). The
            # depth channel breaks the degeneracy — align the current KF's
            # depth-backprojected features to the matched hood landmarks
            # with a fixed-budget Horn RANSAC in METERS (solver/horn.py),
            # where a depth-axis error costs what it should.
            from pslam.solver.horn import se3_ransac_3d3d

            sel = np.flatnonzero(pidx[: len(mp_ids)] >= 0)
            f = pidx[sel]
            z = m.kf_feat_depth[kf, f]
            has_z = z > 0
            RC = 512
            Xl = np.zeros((RC, 3), np.float32)
            Xc = np.zeros((RC, 3), np.float32)
            vmask3 = np.zeros(RC, bool)
            nr = min(len(sel), RC)
            uvf = m.kf_uv[kf, f[:nr]]
            zf = z[:nr]
            Xc[:nr, 0] = (uvf[:, 0] - cfg.camera.cx) / cfg.camera.fx * zf
            Xc[:nr, 1] = (uvf[:, 1] - cfg.camera.cy) / cfg.camera.fy * zf
            Xc[:nr, 2] = zf
            Xl[:nr] = m.mp_pos[mp_ids[sel[:nr]]]
            vmask3[:nr] = has_z[:nr]
            sigma_c = 0.03  # constraint noise floor when the metric
            # refinement cannot run (reprojection-only Sim3 on a
            # plane-dominant hood — see the degeneracy note above)
            if int(vmask3.sum()) >= 30:
                T3, inl3, n3 = se3_ransac_3d3d(
                    jnp.asarray(Xl), jnp.asarray(Xc), jnp.asarray(vmask3),
                    jax.random.PRNGKey(kf * 1301 + rank), inlier_th=0.05,
                )
                if int(n3) >= 30:
                    Scw = sim3_from_se3(T3)
                    # Constraint self-noise: RMS of the inlier 3D-3D
                    # residuals in meters. Residuals share the map's
                    # structure error, so they do NOT average out with n —
                    # the RMS itself is the honest noise scale for the
                    # innovation blend in on_new_keyframe.
                    T3h = np.asarray(T3)
                    res = (Xl @ T3h[:3, :3].T + T3h[:3, 3]) - Xc
                    im = np.asarray(inl3) & vmask3
                    if im.any():
                        sigma_c = float(
                            np.sqrt(np.mean(np.sum(res[im] ** 2, -1)))
                        )

            self.stats["detected"] += 1
            return cand, Scw, mp_ids, pidx[: len(mp_ids)], sigma_c
        return None

    # -- CorrectLoop (LoopClosing.cc:402-615) --------------------------------

    def correct_loop(self, kf: int, loop_kf: int, Scw: Sim3, loop_mp_ids,
                     proj_idx):
        sys_, m = self.sys, self.sys.map
        # InterruptBA (LoopClosing.cc:404-418 RequestStop + mbAbortBA): the
        # in-flight local BA was solved against pre-correction poses —
        # discard it rather than let it clobber the corrected map.
        sys_._interrupt_ba()
        cfg = sys_.cfg
        K = m.n_kf

        poses_before = m.kf_pose[:K].copy()
        covis_before = m.covis[:K, :K].copy()

        # Current covisible group + corrected Sim3 propagation
        # (LoopClosing.cc:437-470).
        group = np.unique(np.r_[[kf], m.covisible_kfs(kf)].astype(np.int64))
        T_kf_old = poses_before[kf]
        S_corr = {int(kf): Scw}
        T_kf_old_inv = np.linalg.inv(T_kf_old)
        for k in group:
            k = int(k)
            if k == kf:
                continue
            T_ik = m.kf_pose[k] @ T_kf_old_inv  # cam_kf -> cam_k
            S_ik = sim3_from_se3(jnp.asarray(T_ik.astype(np.float32)))
            S_corr[k] = sim3_compose(S_ik, Scw)

        # Retransform landmarks seen by the group and update group poses
        # (LoopClosing.cc:471-514): X <- S_corr^-1 (S_old (X)).
        corrected_pts = set()
        for k, S_k in S_corr.items():
            S_old = sim3_from_se3(
                jnp.asarray(poses_before[k].astype(np.float32))
            )
            warp = sim3_compose(sim3_inverse(S_k), S_old)
            mp = m.kf_feat_mp[k]
            ids = np.unique(mp[mp >= 0])
            ids = ids[m.mp_valid[ids]]
            ids = np.asarray([i for i in ids if i not in corrected_pts], np.int64)
            if len(ids):
                m.mp_pos[ids] = np.asarray(
                    sim3_transform_points(warp, jnp.asarray(m.mp_pos[ids]))
                )
                corrected_pts.update(int(i) for i in ids)
            self._warp_lines_lils(k, warp)
            m.kf_pose[k] = np.asarray(sim3_to_se3(S_k))

        # SearchAndFuse over the whole corrected group (LoopClosing.cc:516-537
        # + SearchAndFuse at :587): project the loop neighborhood's map points
        # through each group member's corrected Sim3 and fuse. A duplicate is
        # replaced GLOBALLY (MapPoint::Replace semantics) so every observer of
        # the duplicate switches to the loop point.
        P = cfg.caps.local_points
        pos = np.zeros((P, 3), np.float32)
        desc = np.zeros((P, 32), np.uint8)
        okp = np.zeros(P, bool)
        pos[: len(loop_mp_ids)] = m.mp_pos[loop_mp_ids]
        desc[: len(loop_mp_ids)] = m.mp_desc[loop_mp_ids]
        okp[: len(loop_mp_ids)] = True
        for k, S_k in S_corr.items():
            pidx = np.asarray(
                _match_by_projection_sim3(
                    cfg.camera, S_k, jnp.asarray(pos), jnp.asarray(desc),
                    jnp.asarray(okp), jnp.asarray(m.kf_uv[k]),
                    jnp.asarray(m.kf_desc[k]), jnp.asarray(m.kf_angle[k]),
                    jnp.asarray(m.kf_feat_valid[k]), 8.0,
                )
            )
            for i in np.flatnonzero(pidx[: len(loop_mp_ids)] >= 0):
                lmp = int(loop_mp_ids[i])
                f = int(pidx[i])
                old = int(m.kf_feat_mp[k, f])
                if old == lmp or not m.mp_valid[lmp]:
                    continue
                if old >= 0 and m.mp_valid[old]:
                    # MapPoint::Replace semantics including duplicate-
                    # observation erasure when a KF already sees ``lmp``.
                    m.replace_map_point(old, lmp)
                else:
                    m.kf_feat_mp[k, f] = lmp
                    m.mp_n_obs[lmp] += 1
        for k in S_corr:
            m._update_covisibility(int(k))

        # New loop connections: covisibility edges between the corrected group
        # and the rest of the graph that appeared only through fusion
        # (LoopClosing.cc:540-563). Their measurements must come from the
        # CORRECTED states, not the drifted pre-correction poses.
        group_set = set(int(g) for g in S_corr)
        new_conn = []
        for a in group_set:
            nbrs = np.flatnonzero(m.covis[a, :K] >= ESSENTIAL_MIN_WEIGHT)
            for b in nbrs:
                b = int(b)
                if b in group_set or covis_before[a, b] >= COVIS_TH:
                    continue
                new_conn.append((a, b))

        # Essential graph (Optimizer.cc:2536): spanning chain + strong covis
        # + loop edges; loop KF fixed.
        self.loop_edges.append((int(kf), int(loop_kf)))
        S_opt = self._run_essential_graph(
            K, poses_before, S_corr, loop_kf, covis_before, new_conn
        )

        # Write back poses + landmark correction via each landmark's
        # reference KF (Optimizer.cc:2759-2797).
        poses_mid = m.kf_pose[:K].copy()
        s_opt = np.asarray(S_opt.s)
        R_opt = np.asarray(S_opt.R)
        t_opt = np.asarray(S_opt.t)
        for k in range(K):
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = R_opt[k]
            T[:3, 3] = t_opt[k] / max(s_opt[k], 1e-12)
            m.kf_pose[k] = T
        self._correct_landmarks_by_ref_kf(K, poses_mid, S_opt)

        self.last_loop_seq = int(m.kf_seq[kf])
        self.stats["closed"] += 1

        # Global BA (RunGlobalBundleAdjustment, LoopClosing.cc:645).
        if cfg.loop_gba:
            from pslam.pipeline.global_ba import run_global_ba

            run_global_ba(m, cfg)
            self.stats["gba_runs"] += 1

    def _warp_lines_lils(self, k: int, warp: Sim3):
        m = self.sys.map
        if not self.sys.cfg.use_lines:
            return
        ml = m.kf_line_ml[k]
        ids = np.unique(ml[ml >= 0])
        ids = ids[m.ml_valid[ids]] if len(ids) else ids
        if len(ids):
            pos = m.ml_pos[ids].reshape(-1, 3)
            m.ml_pos[ids] = np.asarray(
                sim3_transform_points(warp, jnp.asarray(pos))
            ).reshape(-1, 6)
        il = m.kf_lil_il[k]
        ids = np.unique(il[il >= 0])
        ids = ids[m.il_valid[ids]] if len(ids) else ids
        if len(ids):
            st = m.il_state[ids].reshape(-1, 3)
            m.il_state[ids] = np.asarray(
                sim3_transform_points(warp, jnp.asarray(st))
            ).reshape(-1, 15)
            # Refresh plane (n, d) from warped support points.
            pts = m.il_state[ids].reshape(-1, 5, 3)
            n = m.il_plane[ids, :3]
            Rw = np.asarray(warp.R)
            n = (n @ Rw.T).astype(np.float32)
            d = -np.einsum("qj,qpj->q", n, pts) / 5.0
            flip = d < 0
            m.il_plane[ids] = np.concatenate(
                [np.where(flip[:, None], -n, n), np.abs(d)[:, None]], axis=1
            ).astype(np.float32)

    def _run_essential_graph(self, K, poses_before, S_corr, loop_kf,
                             covis_before, new_conn):
        Kc = self.sys.cfg.caps.max_keyframes

        s = np.ones(Kc, np.float32)
        R = np.tile(np.eye(3, dtype=np.float32), (Kc, 1, 1))
        t = np.zeros((Kc, 3), np.float32)
        for k in range(K):
            if k in S_corr:
                s[k] = float(np.asarray(S_corr[k].s))
                R[k] = np.asarray(S_corr[k].R)
                t[k] = np.asarray(S_corr[k].t)
            else:
                R[k] = poses_before[k][:3, :3]
                t[k] = poses_before[k][:3, 3]

        # Pre-existing structure edges are measured from PRE-correction
        # relative poses (Optimizer.cc:2614-2657: spanning tree + covis >=
        # minFeat use NonCorrectedSim3); loop edges and the NEW post-fusion
        # loop connections are measured at the CORRECTED states
        # (Optimizer.cc:2601-2612 builds them from vScw).
        ei, ej, ms, mR, mt = [], [], [], [], []
        inserted = set()

        def add_edge(i, j, Ti, Tj):
            # S_ji = S_j o S_i^-1 from the given SE3 poses (scale 1).
            if (min(i, j), max(i, j)) in inserted:
                return
            inserted.add((min(i, j), max(i, j)))
            Tji = Tj @ np.linalg.inv(Ti)
            ei.append(i)
            ej.append(j)
            ms.append(1.0)
            mR.append(Tji[:3, :3])
            mt.append(Tji[:3, 3])

        def add_corrected_edge(a, b):
            if (min(a, b), max(a, b)) in inserted:
                return
            inserted.add((min(a, b), max(a, b)))
            Sa = Sim3(
                s=jnp.asarray(s[a]), R=jnp.asarray(R[a]), t=jnp.asarray(t[a])
            )
            Sb = Sim3(
                s=jnp.asarray(s[b]), R=jnp.asarray(R[b]), t=jnp.asarray(t[b])
            )
            Sba = sim3_compose(Sb, sim3_inverse(Sa))
            ei.append(a)
            ej.append(b)
            ms.append(float(np.asarray(Sba.s)))
            mR.append(np.asarray(Sba.R))
            mt.append(np.asarray(Sba.t))

        for a, b in self.loop_edges:
            add_corrected_edge(a, b)
        for a, b in new_conn:
            add_corrected_edge(a, b)
        # Spanning chain over valid KFs in TEMPORAL order (slot order is not
        # insertion order once culled slots are recycled).
        m = self.sys.map
        alive = np.flatnonzero(m.kf_valid[:K])
        alive = alive[np.argsort(m.kf_frame_id[alive], kind="stable")]
        for a, b in zip(alive[:-1], alive[1:]):
            add_edge(int(a), int(b), poses_before[a], poses_before[b])
        ii, jj = np.nonzero(np.triu(covis_before, 2) >= ESSENTIAL_MIN_WEIGHT)
        for a, b in zip(ii, jj):
            add_edge(int(a), int(b), poses_before[a], poses_before[b])

        E = len(ei)
        fixed = np.zeros(Kc, bool)
        fixed[loop_kf] = True
        vvalid = np.zeros(Kc, bool)
        vvalid[:K] = m.kf_valid[:K]

        # Distributed path: pad the edge set to the mesh size and shard it
        # (parallel/sharded_graph.py); identity-measurement padding keeps the
        # masked edges' sim3_log finite.
        n_dev = len(jax.devices()) if self.sys.cfg.distributed else 1
        Ep = ((E + n_dev - 1) // n_dev) * n_dev if n_dev > 1 else E
        e_i = np.zeros(Ep, np.int32)
        e_j = np.zeros(Ep, np.int32)
        e_s = np.ones(Ep, np.float32)
        e_R = np.tile(np.eye(3, dtype=np.float32), (Ep, 1, 1))
        e_t = np.zeros((Ep, 3), np.float32)
        e_ok = np.zeros(Ep, bool)
        e_i[:E] = np.asarray(ei, np.int32)
        e_j[:E] = np.asarray(ej, np.int32)
        e_s[:E] = np.asarray(ms, np.float32)
        e_R[:E] = np.stack(mR).astype(np.float32)
        e_t[:E] = np.stack(mt).astype(np.float32)
        e_ok[:E] = True
        prob = PoseGraphProblem(
            S=Sim3(s=jnp.asarray(s), R=jnp.asarray(R), t=jnp.asarray(t)),
            fixed=jnp.asarray(fixed),
            vertex_valid=jnp.asarray(vvalid),
            e_i=jnp.asarray(e_i),
            e_j=jnp.asarray(e_j),
            e_Sji=Sim3(
                s=jnp.asarray(e_s), R=jnp.asarray(e_R), t=jnp.asarray(e_t)
            ),
            e_valid=jnp.asarray(e_ok),
        )
        if n_dev > 1:
            from pslam.parallel.sharded_ba import make_ba_mesh
            from pslam.parallel.sharded_graph import (
                optimize_essential_graph_sharded,
            )

            S_opt = optimize_essential_graph_sharded(
                prob, make_ba_mesh(), n_iters=20
            )
        else:
            S_opt = optimize_essential_graph(prob, n_iters=20)
        return jax.tree.map(lambda a: a[:K], S_opt)

    def _correct_landmarks_by_ref_kf(self, K, poses_mid, S_opt):
        """X <- S_opt_ref^-1 (S_mid_ref (X)) per landmark reference KF."""
        m = self.sys.map
        s_opt = np.asarray(S_opt.s)
        R_opt = np.asarray(S_opt.R)
        t_opt = np.asarray(S_opt.t)
        for k in range(K):
            S_mid = sim3_from_se3(jnp.asarray(poses_mid[k].astype(np.float32)))
            S_k = Sim3(
                s=jnp.asarray(s_opt[k]), R=jnp.asarray(R_opt[k]),
                t=jnp.asarray(t_opt[k]),
            )
            warp = sim3_compose(sim3_inverse(S_k), S_mid)
            # Cheap identity check to skip untouched KFs.
            w_np = np.asarray(warp.t)
            if (
                abs(float(np.asarray(warp.s)) - 1) < 1e-7
                and np.abs(np.asarray(warp.R) - np.eye(3)).max() < 1e-7
                and np.abs(w_np).max() < 1e-7
            ):
                continue
            ids = np.flatnonzero(m.mp_valid & (m.mp_first_kf == k))
            if len(ids):
                m.mp_pos[ids] = np.asarray(
                    sim3_transform_points(warp, jnp.asarray(m.mp_pos[ids]))
                )
            if self.sys.cfg.use_lines:
                lids = np.flatnonzero(m.ml_valid & (m.ml_first_kf == k))
                if len(lids):
                    m.ml_pos[lids] = np.asarray(
                        sim3_transform_points(
                            warp, jnp.asarray(m.ml_pos[lids].reshape(-1, 3))
                        )
                    ).reshape(-1, 6)

    # -- Run (one iteration per new KF; LoopClosing.cc:57-88) ----------------

    def on_new_keyframe(self, kf: int) -> bool:
        cands = self.detect_loop(kf)
        if not cands:
            return False
        out = self.compute_sim3(kf, cands)
        if out is None:
            return False
        loop_kf, Scw, loop_mp_ids, proj_idx, sigma_c = out
        if not self._innovation_supported(kf, Scw, loop_mp_ids):
            # The loop is real but the current pose already explains the
            # loop neighbourhood at least as well as the Sim3 constraint —
            # the map has not drifted beyond the constraint's own noise
            # floor. Applying the "correction" would only inject that noise
            # (the reference never faces this: its ~1M-word ORBvoc on real
            # imagery yields constraints well below typical drift). Fuse
            # the duplicate landmarks and record the loop edge, skip the
            # pose surgery.
            self.fuse_only(kf, loop_kf, loop_mp_ids)
            return True
        if not self._group_agrees(kf, Scw, loop_mp_ids):
            # Geometric consistency (VERDICT r4 item 4a): the reference's
            # 3-group check (LoopClosing.cc:152-211) is *temporal*; this
            # adds a *geometric* one — a second covisible KF, moved by the
            # same correction, must also explain the loop neighbourhood
            # better than its current pose. A place-recognition alias that
            # happens to fit ONE keyframe fails here.
            self.fuse_only(kf, loop_kf, loop_mp_ids)
            return True
        Scw, alpha = self._blend_innovation(kf, Scw, sigma_c)
        self.stats["blend_alpha"] = alpha
        if alpha < 0.2:
            # The correction is dominated by the constraint's own noise
            # (drift << sigma_c): pose surgery would inject more error
            # than it removes. Merge duplicates only.
            self.fuse_only(kf, loop_kf, loop_mp_ids)
            return True
        self.correct_loop(kf, loop_kf, Scw, loop_mp_ids, proj_idx)
        return True

    def _blend_innovation(self, kf: int, Scw: Sim3, sigma_c: float):
        """Scale the loop innovation by a Kalman-style gain (VERDICT r4
        item 4b): alpha = d^2 / (d^2 + sigma_c^2), where d is the camera-
        center displacement the correction asks for and sigma_c the
        constraint's measured self-noise (3D-3D inlier RMS). A correct
        closure near the noise floor then degrades gracefully — the
        applied correction shrinks with its own signal-to-noise — instead
        of injecting the full constraint error."""
        from pslam.geometry.lie import sim3_exp, sim3_log

        m = self.sys.map
        T_cur = m.kf_pose[kf].astype(np.float32)
        S_cur = sim3_from_se3(jnp.asarray(T_cur))
        C_cur = -T_cur[:3, :3].T @ T_cur[:3, 3]
        s = float(np.asarray(Scw.s))
        R = np.asarray(Scw.R)
        t = np.asarray(Scw.t)
        C_corr = -(R.T @ t) / max(s, 1e-12)
        d = float(np.linalg.norm(C_corr - C_cur))
        alpha = d * d / (d * d + sigma_c * sigma_c + 1e-12)
        if alpha >= 0.95:
            return Scw, alpha
        xi = sim3_log(sim3_compose(Scw, sim3_inverse(S_cur)))
        S_blend = sim3_compose(sim3_exp(alpha * xi), S_cur)
        return S_blend, alpha

    def _hood_arrays(self, loop_mp_ids):
        m, cfg = self.sys.map, self.sys.cfg
        P = cfg.caps.local_points
        pos = np.zeros((P, 3), np.float32)
        desc = np.zeros((P, 32), np.uint8)
        okp = np.zeros(P, bool)
        nn = min(len(loop_mp_ids), P)
        pos[:nn] = m.mp_pos[loop_mp_ids[:nn]]
        desc[:nn] = m.mp_desc[loop_mp_ids[:nn]]
        okp[:nn] = m.mp_valid[loop_mp_ids[:nn]]
        return pos, desc, okp, nn

    def _count_hood(self, k: int, S: Sim3, pos, desc, okp, nn,
                    radius: float = 3.0) -> int:
        m, cfg = self.sys.map, self.sys.cfg
        idx = np.asarray(
            _match_by_projection_sim3(
                cfg.camera, S, jnp.asarray(pos), jnp.asarray(desc),
                jnp.asarray(okp), jnp.asarray(m.kf_uv[k]),
                jnp.asarray(m.kf_desc[k]), jnp.asarray(m.kf_angle[k]),
                jnp.asarray(m.kf_feat_valid[k]), radius,
            )
        )
        return int((idx[:nn] >= 0).sum())

    def _group_agrees(self, kf: int, Scw: Sim3, loop_mp_ids) -> bool:
        """>= 2 covisible KFs must agree on the same Sim3: propagate the
        correction to the strongest covisible neighbours (exactly as
        correct_loop will) and require one of them to also explain the
        loop neighbourhood better than its current pose. Neighbours with
        no view of the hood (both counts tiny) are skipped as
        evidence-free; if none has evidence, the single-KF gate stands."""
        m = self.sys.map
        nbrs = m.covisible_kfs(kf)
        if len(nbrs) == 0:
            return True
        w = m.covis[kf, nbrs]
        order = np.argsort(-w)
        pos, desc, okp, nn = self._hood_arrays(loop_mp_ids)
        T_kf_inv = np.linalg.inv(m.kf_pose[kf]).astype(np.float32)
        checked = 0
        for k2 in np.asarray(nbrs)[order][:3]:
            k2 = int(k2)
            T_rel = (m.kf_pose[k2] @ T_kf_inv).astype(np.float32)
            S_pred = sim3_compose(
                sim3_from_se3(jnp.asarray(T_rel)), Scw
            )
            S_cur2 = sim3_from_se3(
                jnp.asarray(m.kf_pose[k2].astype(np.float32))
            )
            n_corr = self._count_hood(k2, S_pred, pos, desc, okp, nn)
            n_cur = self._count_hood(k2, S_cur2, pos, desc, okp, nn)
            if max(n_corr, n_cur) < 20:
                continue
            checked += 1
            if n_corr > max(1.2 * n_cur, n_cur + 10):
                return True
        return checked == 0

    def _innovation_supported(self, kf: int, Scw: Sim3,
                              loop_mp_ids) -> bool:
        """Evidence gate for the loop innovation: project the loop
        neighbourhood's landmarks into the current KF through BOTH the
        corrected Sim3 and the current estimated pose with a tight window;
        accept the correction only where it explains clearly more matches."""
        m = self.sys.map
        cfg = self.sys.cfg
        P = cfg.caps.local_points
        pos = np.zeros((P, 3), np.float32)
        desc = np.zeros((P, 32), np.uint8)
        okp = np.zeros(P, bool)
        nn = min(len(loop_mp_ids), P)
        pos[:nn] = m.mp_pos[loop_mp_ids[:nn]]
        desc[:nn] = m.mp_desc[loop_mp_ids[:nn]]
        okp[:nn] = m.mp_valid[loop_mp_ids[:nn]]

        def count(S):
            idx = np.asarray(
                _match_by_projection_sim3(
                    cfg.camera, S, jnp.asarray(pos), jnp.asarray(desc),
                    jnp.asarray(okp), jnp.asarray(m.kf_uv[kf]),
                    jnp.asarray(m.kf_desc[kf]), jnp.asarray(m.kf_angle[kf]),
                    jnp.asarray(m.kf_feat_valid[kf]), 3.0,
                )
            )
            return int((idx[:nn] >= 0).sum())

        S_cur = sim3_from_se3(jnp.asarray(m.kf_pose[kf].astype(np.float32)))
        n_corr = count(Scw)
        n_cur = count(S_cur)
        self.stats["gate_corr"] = n_corr
        self.stats["gate_cur"] = n_cur
        return n_corr > max(1.2 * n_cur, n_cur + 10)

    def fuse_only(self, kf: int, loop_kf: int, loop_mp_ids):
        """Low-innovation loop acceptance: merge duplicate landmarks between
        the current covisible group and the loop neighbourhood using the
        CURRENT poses (SearchAndFuse semantics without the Sim3 warp),
        refresh covisibility, and record the loop edge for the essential
        graph / KF-culling protection."""
        self.stats["fuse_only"] = self.stats.get("fuse_only", 0) + 1
        m = self.sys.map
        cfg = self.sys.cfg
        P = cfg.caps.local_points
        pos = np.zeros((P, 3), np.float32)
        desc = np.zeros((P, 32), np.uint8)
        okp = np.zeros(P, bool)
        nn = min(len(loop_mp_ids), P)
        pos[:nn] = m.mp_pos[loop_mp_ids[:nn]]
        desc[:nn] = m.mp_desc[loop_mp_ids[:nn]]
        okp[:nn] = m.mp_valid[loop_mp_ids[:nn]]
        group = np.unique(np.r_[[kf], m.covisible_kfs(kf)].astype(np.int64))
        for k in group:
            k = int(k)
            S_k = sim3_from_se3(jnp.asarray(m.kf_pose[k].astype(np.float32)))
            pidx = np.asarray(
                _match_by_projection_sim3(
                    cfg.camera, S_k, jnp.asarray(pos), jnp.asarray(desc),
                    jnp.asarray(okp), jnp.asarray(m.kf_uv[k]),
                    jnp.asarray(m.kf_desc[k]), jnp.asarray(m.kf_angle[k]),
                    jnp.asarray(m.kf_feat_valid[k]), 4.0,
                )
            )
            for i in np.flatnonzero(pidx[:nn] >= 0):
                lmp = int(loop_mp_ids[i])
                f = int(pidx[i])
                old = int(m.kf_feat_mp[k, f])
                if old == lmp or not m.mp_valid[lmp]:
                    continue
                if old >= 0 and m.mp_valid[old]:
                    m.replace_map_point(old, lmp)
                elif lmp in m.kf_feat_mp[k]:
                    # KF k already observes this loop landmark through a
                    # different feature slot (possibly via a replace above);
                    # a second binding would double-count the (KF, point)
                    # pair (ADVICE r4 — mirror replace_map_point's sees_new
                    # guard).
                    continue
                else:
                    m.kf_feat_mp[k, f] = lmp
                    m.mp_n_obs[lmp] += 1
            m._update_covisibility(k)
        self.loop_edges.append((int(kf), int(loop_kf)))
        self.last_loop_seq = int(m.kf_seq[kf])
        self.stats["fuse_only"] = self.stats.get("fuse_only", 0) + 1
        self.stats["closed"] += 1
