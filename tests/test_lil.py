"""Structural-line (LIL) solver tests: Jacobians vs autodiff, pose opt with
LIL terms, joint point+LIL local BA."""

import jax
import jax.numpy as jnp
import numpy as np

import pslam.geometry as geo
from pslam.geometry import Camera, project, se3_exp, transform_points
from pslam.solver.ba_lil import LILBAEdges, local_bundle_adjustment_lil
from pslam.solver.lil import LILPoseObs, lil_residual_jac
from pslam.solver.local_ba import BAProblem
from pslam.solver.pose_opt import PoseObs, pose_optimization

CAM = Camera(fx=400.0, fy=400.0, cx=320.0, cy=240.0, bf=40.0)


def _make_lils(rng, n, T_cw=None):
    """Random coplanar-ish LIL states (world) + exact observations from pose
    T_cw (identity default). Returns (state (n,15), obs (n,8))."""
    T = np.eye(4, dtype=np.float32) if T_cw is None else np.asarray(T_cw)
    states, obses = [], []
    for _ in range(n):
        X = rng.uniform([-1.5, -1.0, 3.0], [1.5, 1.0, 6.0]).astype(np.float32)
        d1 = rng.normal(size=3)
        d1 /= np.linalg.norm(d1)
        d2 = rng.normal(size=3)
        d2 -= d1 * (d1 @ d2)
        d2 /= np.linalg.norm(d2)
        p1s, p1e = X - 0.5 * d1, X + 0.7 * d1
        p2s, p2e = X - 0.6 * d2, X + 0.4 * d2
        state = np.concatenate([p1s, p1e, p2s, p2e, X]).astype(np.float32)

        pts_c = np.asarray(
            transform_points(jnp.asarray(T), jnp.asarray(state.reshape(5, 3)))
        )
        uv = np.asarray(project(CAM, jnp.asarray(pts_c)))

        def line_eq(a, b):
            la = a[1] - b[1]
            lb = b[0] - a[0]
            lc = a[0] * b[1] - a[1] * b[0]
            n_ = np.hypot(la, lb)
            return np.array([la / n_, lb / n_, lc / n_])

        l1 = line_eq(uv[0], uv[1])
        l2 = line_eq(uv[2], uv[3])
        obs = np.concatenate([l1, l2, uv[4]]).astype(np.float32)
        states.append(state)
        obses.append(obs)
    return np.stack(states), np.stack(obses)


class TestLILJacobians:
    def test_pose_jacobian_matches_autodiff(self):
        rng = np.random.default_rng(0)
        state, obs = _make_lils(rng, 4)
        xi0 = jnp.asarray([0.03, -0.02, 0.05, 0.1, -0.2, 0.15], jnp.float32)
        T = se3_exp(xi0)

        r, J_pose, J_lm, _ = lil_residual_jac(
            CAM, T[None], jnp.asarray(state), jnp.asarray(obs)
        )

        def res_of_xi(xi):
            Tn = se3_exp(xi) @ T
            rr, *_ = lil_residual_jac(
                CAM, Tn[None], jnp.asarray(state), jnp.asarray(obs)
            )
            return rr

        J_auto = jax.jacfwd(res_of_xi)(jnp.zeros(6, jnp.float32))
        # J_auto: (n, 6, 6) with last axis = xi.
        assert np.allclose(np.asarray(J_pose), np.asarray(J_auto), atol=1e-3), (
            np.abs(np.asarray(J_pose) - np.asarray(J_auto)).max()
        )

    def test_landmark_jacobian_matches_autodiff(self):
        rng = np.random.default_rng(1)
        state, obs = _make_lils(rng, 3)
        xi0 = jnp.asarray([0.02, 0.04, -0.03, -0.1, 0.2, 0.1], jnp.float32)
        T = se3_exp(xi0)

        r, J_pose, J_lm, _ = lil_residual_jac(
            CAM, T[None], jnp.asarray(state), jnp.asarray(obs)
        )

        def res_of_shift(s):
            st = jnp.asarray(state) + jnp.tile(s, 5)[None, :]
            rr, *_ = lil_residual_jac(CAM, T[None], st, jnp.asarray(obs))
            return rr

        J_auto = jax.jacfwd(res_of_shift)(jnp.zeros(3, jnp.float32))
        assert np.allclose(np.asarray(J_lm), np.asarray(J_auto), atol=1e-3)

    def test_residual_zero_at_truth(self):
        rng = np.random.default_rng(2)
        xi = jnp.asarray([0.1, -0.05, 0.02, 0.3, 0.1, -0.2], jnp.float32)
        T = se3_exp(xi)
        state, obs = _make_lils(rng, 5, T_cw=np.asarray(T))
        r, *_ = lil_residual_jac(CAM, T[None], jnp.asarray(state), jnp.asarray(obs))
        assert np.abs(np.asarray(r)).max() < 1e-2


class TestPoseOptWithLIL:
    def test_lil_terms_improve_weakly_constrained_pose(self):
        """Points + LILs together recover the pose; LIL inliers flagged."""
        rng = np.random.default_rng(3)
        T_true = se3_exp(jnp.asarray([0.05, 0.02, -0.04, 0.2, -0.1, 0.3], jnp.float32))

        n = 60
        X = rng.uniform([-2, -1.5, 2.5], [2, 1.5, 7], (n, 3)).astype(np.float32)
        Xc = np.asarray(transform_points(T_true, jnp.asarray(X)))
        uvr = np.asarray(geo.project_stereo(CAM, jnp.asarray(Xc))).copy()
        uvr[:, :2] += rng.normal(0, 0.4, (n, 2))
        po = PoseObs(
            X_w=jnp.asarray(X),
            obs=jnp.asarray(uvr.astype(np.float32)),
            inv_sigma2=jnp.ones(n, jnp.float32),
            valid=jnp.ones(n, bool),
        )
        state, obs = _make_lils(rng, 6, T_cw=np.asarray(T_true))
        lil = LILPoseObs(
            state=jnp.asarray(state), obs=jnp.asarray(obs),
            valid=jnp.ones(len(state), bool),
        )

        T_init = se3_exp(jnp.asarray([0.02, -0.02, 0.02, 0.1, 0.1, -0.1], jnp.float32)) @ T_true
        T_opt, inl, chi2, lil_inl = pose_optimization(CAM, T_init, po, lil=lil)
        err = np.asarray(geo.se3_log(T_opt @ geo.se3_inverse(T_true)))
        assert np.abs(err[:3]).max() < 3e-3
        assert np.abs(err[3:]).max() < 2e-2
        assert np.asarray(lil_inl).all()

    def test_bad_lil_flagged_outlier(self):
        rng = np.random.default_rng(4)
        T_true = geo.se3_identity()
        n = 80
        X = rng.uniform([-2, -1.5, 2.5], [2, 1.5, 7], (n, 3)).astype(np.float32)
        uvr = np.asarray(geo.project_stereo(CAM, jnp.asarray(X)))
        po = PoseObs(
            X_w=jnp.asarray(X),
            obs=jnp.asarray(uvr.astype(np.float32)),
            inv_sigma2=jnp.ones(n, jnp.float32),
            valid=jnp.ones(n, bool),
        )
        state, obs = _make_lils(rng, 4)
        obs[0, 6:8] += 300.0  # gross crosspoint outlier
        lil = LILPoseObs(
            state=jnp.asarray(state), obs=jnp.asarray(obs),
            valid=jnp.ones(len(state), bool),
        )
        T_opt, inl, chi2, lil_inl = pose_optimization(CAM, T_true, po, lil=lil)
        lil_inl = np.asarray(lil_inl)
        assert not lil_inl[0]
        assert lil_inl[1:].all()
        err = np.asarray(geo.se3_log(T_opt))
        assert np.abs(err).max() < 5e-3


class TestLocalBAWithLIL:
    def test_joint_ba_converges(self):
        rng = np.random.default_rng(5)
        C, P, Q, n_free = 4, 120, 6, 2
        X = rng.uniform([-2, -1.5, 2.5], [2, 1.5, 7], (P, 3)).astype(np.float32)
        poses = []
        for i in range(C):
            xi = np.concatenate(
                [rng.normal(0, 0.02, 3), [0.3 * i - 0.45, 0, 0.02 * i]]
            ).astype(np.float32)
            poses.append(np.asarray(se3_exp(jnp.asarray(xi))))
        T_true = np.stack(poses)

        # Point edges: every camera sees every point.
        cam_idx = np.repeat(np.arange(C), P).astype(np.int32)
        pt_idx = np.tile(np.arange(P), C).astype(np.int32)
        Xc = np.asarray(
            transform_points(jnp.asarray(T_true)[cam_idx], jnp.asarray(X)[pt_idx])
        )
        obs = np.asarray(geo.project_stereo(CAM, jnp.asarray(Xc))).copy()
        obs[:, :2] += rng.normal(0, 0.3, (len(obs), 2))

        # LIL edges: every camera observes every LIL.
        lil_states, _ = _make_lils(rng, Q)
        le_cam, le_lil, le_obs = [], [], []
        for c in range(C):
            for q in range(Q):
                # observation of LIL q from camera c: recompute exactly
                state_q = lil_states[q]
                pts_c = np.asarray(
                    transform_points(
                        jnp.asarray(T_true[c]), jnp.asarray(state_q.reshape(5, 3))
                    )
                )
                uv = np.asarray(project(CAM, jnp.asarray(pts_c)))

                def line_eq(a, b):
                    la, lb = a[1] - b[1], b[0] - a[0]
                    lc = a[0] * b[1] - a[1] * b[0]
                    nn = np.hypot(la, lb)
                    return np.array([la / nn, lb / nn, lc / nn])

                le_cam.append(c)
                le_lil.append(q)
                le_obs.append(
                    np.concatenate(
                        [line_eq(uv[0], uv[1]), line_eq(uv[2], uv[3]), uv[4]]
                    )
                )
        le_cam = np.asarray(le_cam, np.int32)
        le_lil = np.asarray(le_lil, np.int32)
        le_obs = np.asarray(le_obs, np.float32)

        # Perturb: free cams 1..2, all points, LIL structures shifted.
        free_slot = np.full(C, -1, np.int32)
        free_slot[1 : 1 + n_free] = np.arange(n_free)
        T_init = T_true.copy()
        for s, c in enumerate(range(1, 1 + n_free)):
            T_init[c] = np.asarray(
                se3_exp(jnp.asarray(rng.normal(0, 0.01, 6).astype(np.float32) * 2))
            ) @ T_init[c]
        X_init = X + rng.normal(0, 0.03, X.shape).astype(np.float32)
        lil_init = lil_states + np.tile(
            rng.normal(0, 0.05, (Q, 3)).astype(np.float32), (1, 5)
        )

        prob = BAProblem(
            T_cw=jnp.asarray(T_init.astype(np.float32)),
            free_slot=jnp.asarray(free_slot),
            X_w=jnp.asarray(X_init),
            point_valid=jnp.ones(P, bool),
            cam_idx=jnp.asarray(cam_idx),
            pt_idx=jnp.asarray(pt_idx),
            obs=jnp.asarray(obs.astype(np.float32)),
            inv_sigma2=jnp.ones(len(obs), jnp.float32),
            edge_valid=jnp.ones(len(obs), bool),
        )
        ledges = LILBAEdges(
            cam_idx=jnp.asarray(le_cam),
            lil_idx=jnp.asarray(le_lil),
            obs=jnp.asarray(le_obs),
            valid=jnp.ones(len(le_cam), bool),
        )

        T_opt, X_opt, lil_opt, in_p, in_l = local_bundle_adjustment_lil(
            CAM, prob, jnp.asarray(lil_init), jnp.ones(Q, bool), ledges, n_free
        )

        # Free poses recovered.
        for c in range(1, 1 + n_free):
            err = np.asarray(
                geo.se3_log(jnp.asarray(T_opt)[c] @ geo.se3_inverse(jnp.asarray(T_true[c])))
            )
            assert np.abs(err).max() < 5e-3, (c, err)
        # LIL crosspoints pulled back toward truth.
        err_before = np.linalg.norm(lil_init[:, 12:15] - lil_states[:, 12:15], axis=1)
        err_after = np.linalg.norm(
            np.asarray(lil_opt)[:, 12:15] - lil_states[:, 12:15], axis=1
        )
        assert err_after.mean() < 0.4 * err_before.mean()
        assert np.asarray(in_l).mean() > 0.9
