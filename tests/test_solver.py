"""Solver tests: analytic Jacobians vs autodiff, pose opt and local BA
convergence on synthetic ground-truth problems (SURVEY.md §4 strategy)."""

import jax
import jax.numpy as jnp
import numpy as np

from pslam import geometry as geo
from pslam.solver import (
    BAProblem,
    PoseObs,
    local_bundle_adjustment,
    mono_residual_jac,
    pose_optimization,
    stereo_residual_jac,
)

CAM = geo.Camera(fx=517.3, fy=516.5, cx=318.6, cy=255.3, bf=40.0)


def make_scene(seed=0, n_pts=200):
    rng = np.random.default_rng(seed)
    X = rng.uniform([-2, -1.5, 1.0], [2, 1.5, 6.0], size=(n_pts, 3)).astype(np.float32)
    xi_true = np.array([0.03, -0.05, 0.02, 0.2, -0.1, 0.15], np.float32)
    T_true = geo.se3_exp(jnp.asarray(xi_true))
    return jnp.asarray(X), T_true


class TestJacobians:
    def test_mono_jacobian_vs_autodiff(self):
        X, T = make_scene(1, 50)
        obs = geo.project(CAM, geo.transform_points(T, X))

        def res_pose(xi):
            r, _, _ = mono_residual_jac(CAM, geo.se3_exp(xi) @ T, X, obs)
            return r

        def res_point(Xp):
            r, _, _ = mono_residual_jac(CAM, T, Xp, obs)
            return r

        _, J_pose, J_point = mono_residual_jac(CAM, T, X, obs)
        J_pose_ad = jax.jacfwd(res_pose)(jnp.zeros(6))  # (N, 2, 6)
        np.testing.assert_allclose(np.asarray(J_pose), np.asarray(J_pose_ad), atol=1e-3)
        J_point_ad = jax.jacfwd(res_point)(X)  # (N, 2, N, 3)
        J_pt_diag = np.asarray(J_point_ad)[np.arange(50), :, np.arange(50), :]
        np.testing.assert_allclose(np.asarray(J_point), J_pt_diag, atol=1e-3)

    def test_stereo_jacobian_vs_autodiff(self):
        X, T = make_scene(2, 50)
        obs = geo.project_stereo(CAM, geo.transform_points(T, X))

        def res_pose(xi):
            r, _, _ = stereo_residual_jac(CAM, geo.se3_exp(xi) @ T, X, obs)
            return r

        _, J_pose, J_point = stereo_residual_jac(CAM, T, X, obs)
        J_pose_ad = jax.jacfwd(res_pose)(jnp.zeros(6))
        np.testing.assert_allclose(np.asarray(J_pose), np.asarray(J_pose_ad), atol=1e-3)


class TestPoseOptimization:
    def _problem(self, seed, outlier_frac=0.0, n=256):
        rng = np.random.default_rng(seed)
        X, T_true = make_scene(seed, n)
        uvr = geo.project_stereo(CAM, geo.transform_points(T_true, X))
        uvr = np.array(uvr)
        uvr[:, :2] += rng.normal(0, 0.5, size=(n, 2))  # 0.5 px noise
        uvr[:, 2] += rng.normal(0, 0.5, size=n)
        n_out = int(outlier_frac * n)
        out_idx = rng.choice(n, n_out, replace=False)
        uvr[out_idx, :2] += rng.uniform(20, 80, size=(n_out, 2))
        # Mark 30% of edges mono (no depth).
        mono = rng.random(n) < 0.3
        uvr[mono, 2] = -1.0
        po = PoseObs(
            X_w=X,
            obs=jnp.asarray(uvr.astype(np.float32)),
            inv_sigma2=jnp.ones(n, jnp.float32),
            valid=jnp.ones(n, bool),
        )
        return po, T_true, out_idx

    def test_converges_from_perturbed_init(self):
        po, T_true, _ = self._problem(3)
        xi_pert = jnp.asarray([0.05, -0.03, 0.04, 0.3, 0.2, -0.25], dtype=jnp.float32)
        T_init = geo.se3_exp(xi_pert) @ T_true
        T_opt, inliers, chi2, _ = pose_optimization(CAM, T_init, po)
        err = np.asarray(geo.se3_log(T_opt @ geo.se3_inverse(T_true)))
        assert np.abs(err[:3]).max() < 2e-3, err  # rotation ~< 0.1 deg
        assert np.abs(err[3:]).max() < 1e-2, err  # translation < 1 cm
        assert int(inliers.sum()) > 240

    def test_rejects_outliers(self):
        po, T_true, out_idx = self._problem(4, outlier_frac=0.25)
        xi_pert = jnp.asarray([0.02, 0.02, -0.02, 0.1, -0.1, 0.1], dtype=jnp.float32)
        T_init = geo.se3_exp(xi_pert) @ T_true
        T_opt, inliers, chi2, _ = pose_optimization(CAM, T_init, po)
        err = np.asarray(geo.se3_log(T_opt @ geo.se3_inverse(T_true)))
        assert np.abs(err[3:]).max() < 2e-2, err
        inl = np.asarray(inliers)
        # The planted outliers must be flagged out.
        assert inl[out_idx].mean() < 0.1
        assert inl.mean() > 0.6

    def test_jit_compiles(self):
        po, T_true, _ = self._problem(5)
        f = jax.jit(lambda T, p: pose_optimization(CAM, T, p)[0])
        T_opt = f(T_true, po)
        assert np.all(np.isfinite(np.asarray(T_opt)))


class TestLocalBA:
    def _ba_problem(self, seed=0, n_cams=6, n_pts=300, n_fixed=2):
        rng = np.random.default_rng(seed)
        X = rng.uniform([-3, -2, 2.0], [3, 2, 8.0], size=(n_pts, 3)).astype(np.float32)
        # Cameras on a small arc looking at the cloud.
        poses = []
        for i in range(n_cams):
            xi = np.concatenate(
                [rng.normal(0, 0.02, 3), [0.3 * i - 0.75, 0, 0.05 * i]]
            ).astype(np.float32)
            poses.append(np.asarray(geo.se3_exp(jnp.asarray(xi))))
        T_true = jnp.asarray(np.stack(poses))

        cam_idx, pt_idx, obs = [], [], []
        for c in range(n_cams):
            Xc = np.asarray(geo.transform_points(T_true[c], jnp.asarray(X)))
            uvr = np.asarray(geo.project_stereo(CAM, jnp.asarray(Xc)))
            vis = (
                (Xc[:, 2] > 0.3)
                & (uvr[:, 0] > 0) & (uvr[:, 0] < 640)
                & (uvr[:, 1] > 0) & (uvr[:, 1] < 480)
            )
            idx = np.where(vis)[0]
            cam_idx.append(np.full(len(idx), c))
            pt_idx.append(idx)
            o = uvr[idx] + rng.normal(0, 0.3, size=(len(idx), 3)).astype(np.float32)
            obs.append(o)
        cam_idx = np.concatenate(cam_idx).astype(np.int32)
        pt_idx = np.concatenate(pt_idx).astype(np.int32)
        obs = np.concatenate(obs).astype(np.float32)
        E = len(cam_idx)

        # Perturb free poses and all points.
        T_pert = np.asarray(T_true).copy()
        for c in range(n_fixed, n_cams):
            xi = rng.normal(0, 0.01, 6).astype(np.float32)
            xi[3:] *= 5.0  # up to ~5 cm translation error
            T_pert[c] = np.asarray(geo.se3_exp(jnp.asarray(xi))) @ T_pert[c]
        X_pert = X + rng.normal(0, 0.03, size=X.shape).astype(np.float32)

        free_slot = np.full(n_cams, -1, np.int32)
        free_slot[n_fixed:] = np.arange(n_cams - n_fixed)
        prob = BAProblem(
            T_cw=jnp.asarray(T_pert),
            free_slot=jnp.asarray(free_slot),
            X_w=jnp.asarray(X_pert),
            point_valid=jnp.ones(n_pts, bool),
            cam_idx=jnp.asarray(cam_idx),
            pt_idx=jnp.asarray(pt_idx),
            obs=jnp.asarray(obs),
            inv_sigma2=jnp.ones(E, jnp.float32),
            edge_valid=jnp.ones(E, bool),
        )
        return prob, T_true, jnp.asarray(X), n_cams - n_fixed

    def test_ba_recovers_scene(self):
        prob, T_true, X_true, n_free = self._ba_problem()
        T_opt, X_opt, inlier, chi2 = local_bundle_adjustment(CAM, prob, n_free)
        # Pose error of free cameras vs ground truth.
        rel = T_opt @ geo.se3_inverse(T_true)
        err = np.asarray(jax.vmap(geo.se3_log)(rel))
        pre = np.asarray(jax.vmap(geo.se3_log)(prob.T_cw @ geo.se3_inverse(T_true)))
        assert np.abs(err[2:, 3:]).max() < np.abs(pre[2:, 3:]).max() * 0.2
        assert np.abs(err[2:, 3:]).max() < 0.01  # < 1 cm
        # Points improve too. Far points seen from one view keep an expected
        # ~z^2/bf * sigma depth error, so gate the median, not the max.
        p_err = np.linalg.norm(np.asarray(X_opt) - np.asarray(X_true), axis=-1)
        p_pre = np.linalg.norm(np.asarray(prob.X_w) - np.asarray(X_true), axis=-1)
        assert np.median(p_err) < 0.02
        assert p_err.mean() < p_pre.mean()
        assert float(inlier.mean()) > 0.95

    def test_ba_chi2_decreases_and_jits(self):
        prob, *_ , n_free = self._ba_problem(seed=7)
        f = jax.jit(
            lambda p: local_bundle_adjustment(CAM, p, n_free), static_argnums=()
        )
        T_opt, X_opt, inlier, chi2 = f(prob)
        from pslam.solver.local_ba import _edge_terms

        *_, cost0 = _edge_terms(
            CAM, prob, prob.T_cw, prob.X_w, prob.edge_valid, False
        )
        *_, cost1 = _edge_terms(CAM, prob, T_opt, X_opt, prob.edge_valid, False)
        assert float(cost1) < float(cost0) * 0.1

    def test_fixed_cameras_unmoved(self):
        prob, *_ , n_free = self._ba_problem(seed=8)
        T_opt, _, _, _ = local_bundle_adjustment(CAM, prob, n_free)
        np.testing.assert_allclose(
            np.asarray(T_opt[:2]), np.asarray(prob.T_cw[:2]), atol=1e-7
        )
