"""Geometry core tests: Lie-group round trips, golden values vs scipy, camera."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from pslam import geometry as geo


def rng(seed=0):
    return np.random.default_rng(seed)


class TestSO3:
    def test_exp_matches_scipy(self):
        w = rng(1).normal(size=(64, 3)).astype(np.float32)
        R = np.asarray(geo.so3_exp(jnp.asarray(w)))
        R_ref = Rotation.from_rotvec(w).as_matrix()
        np.testing.assert_allclose(R, R_ref, atol=1e-5)

    def test_log_roundtrip(self):
        w = rng(2).normal(size=(128, 3)).astype(np.float32)
        # Keep |w| < pi for uniqueness of the log.
        w = w / np.maximum(1.0, np.linalg.norm(w, axis=-1, keepdims=True) / 3.0)
        w_rt = np.asarray(geo.so3_log(geo.so3_exp(jnp.asarray(w))))
        np.testing.assert_allclose(w_rt, w, atol=2e-4)

    def test_log_small_angle(self):
        w = np.array([[0.0, 0.0, 0.0], [1e-7, -2e-7, 1e-7]], dtype=np.float32)
        w_rt = np.asarray(geo.so3_log(geo.so3_exp(jnp.asarray(w))))
        np.testing.assert_allclose(w_rt, w, atol=1e-6)

    def test_log_near_pi(self):
        axes = rng(3).normal(size=(32, 3))
        axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
        w = (axes * (np.pi - 1e-3)).astype(np.float32)
        R = Rotation.from_rotvec(w).as_matrix().astype(np.float32)
        w_rt = np.asarray(geo.so3_log(jnp.asarray(R)))
        R_rt = Rotation.from_rotvec(w_rt).as_matrix()
        # Axis sign may flip at pi; compare rotations, not vectors.
        np.testing.assert_allclose(R_rt, R, atol=1e-3)


class TestSE3:
    def test_exp_log_roundtrip(self):
        xi = rng(4).normal(size=(64, 6)).astype(np.float32) * 0.8
        T = geo.se3_exp(jnp.asarray(xi))
        xi_rt = np.asarray(geo.se3_log(T))
        np.testing.assert_allclose(xi_rt, xi, atol=1e-4)

    def test_compose_inverse(self):
        xi = rng(5).normal(size=(16, 6)).astype(np.float32)
        T = geo.se3_exp(jnp.asarray(xi))
        eye = np.asarray(T @ geo.se3_inverse(T))
        np.testing.assert_allclose(
            eye, np.broadcast_to(np.eye(4), (16, 4, 4)), atol=1e-5
        )

    def test_transform_points(self):
        xi = rng(6).normal(size=(6,)).astype(np.float32)
        T = geo.se3_exp(jnp.asarray(xi))
        X = rng(7).normal(size=(100, 3)).astype(np.float32)
        Y = np.asarray(geo.transform_points(T, jnp.asarray(X)))
        R = np.asarray(T)[:3, :3]
        t = np.asarray(T)[:3, 3]
        np.testing.assert_allclose(Y, X @ R.T + t, atol=1e-5)

    def test_left_update_convention(self):
        # Solver updates are T <- exp(xi) @ T; exp([w,u]) must rotate-first
        # like g2o SE3Quat::exp (rotation block independent of u).
        xi = jnp.array([0.1, 0.2, -0.1, 5.0, -3.0, 2.0], dtype=jnp.float32)
        T = geo.se3_exp(xi)
        R_only = geo.so3_exp(xi[:3])
        np.testing.assert_allclose(np.asarray(T)[:3, :3], np.asarray(R_only), atol=1e-6)


class TestSim3:
    def test_exp_log_roundtrip(self):
        z = rng(8).normal(size=(64, 7)).astype(np.float32) * 0.5
        g = geo.sim3_exp(jnp.asarray(z))
        z_rt = np.asarray(geo.sim3_log(g))
        np.testing.assert_allclose(z_rt, z, atol=3e-4)

    def test_sigma_zero_matches_se3(self):
        xi = rng(9).normal(size=(16, 6)).astype(np.float32)
        z = np.concatenate([xi[:, :3], xi[:, 3:], np.zeros((16, 1), np.float32)], -1)
        g = geo.sim3_exp(jnp.asarray(z))
        T = geo.se3_exp(jnp.asarray(xi))
        np.testing.assert_allclose(np.asarray(g.R), np.asarray(T[..., :3, :3]), atol=1e-5)
        np.testing.assert_allclose(np.asarray(g.t), np.asarray(T[..., :3, 3]), atol=1e-4)
        np.testing.assert_allclose(np.asarray(g.s), 1.0, atol=1e-6)

    def test_compose_inverse(self):
        z = rng(10).normal(size=(8, 7)).astype(np.float32) * 0.5
        g = geo.sim3_exp(jnp.asarray(z))
        gi = geo.sim3_inverse(g)
        e = geo.sim3_compose(g, gi)
        np.testing.assert_allclose(np.asarray(e.s), 1.0, atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(e.R), np.broadcast_to(np.eye(3), (8, 3, 3)), atol=1e-5
        )
        np.testing.assert_allclose(np.asarray(e.t), 0.0, atol=1e-4)

    def test_action(self):
        z = rng(11).normal(size=(7,)).astype(np.float32)
        g = geo.sim3_exp(jnp.asarray(z))
        X = rng(12).normal(size=(10, 3)).astype(np.float32)
        Y = np.asarray(geo.sim3_transform_points(g, jnp.asarray(X)))
        Y_ref = float(g.s) * X @ np.asarray(g.R).T + np.asarray(g.t)
        np.testing.assert_allclose(Y, Y_ref, atol=1e-4)


class TestCamera:
    CAM = geo.Camera(fx=517.3, fy=516.5, cx=318.6, cy=255.3, bf=40.0)

    def test_project_backproject(self):
        uv = rng(13).uniform([0, 0], [640, 480], size=(50, 2)).astype(np.float32)
        z = rng(14).uniform(0.5, 5.0, size=(50,)).astype(np.float32)
        X = geo.backproject(self.CAM, jnp.asarray(uv), jnp.asarray(z))
        uv_rt = np.asarray(geo.project(self.CAM, X))
        np.testing.assert_allclose(uv_rt, uv, atol=1e-3)

    def test_stereo_disparity(self):
        X = jnp.array([[0.5, -0.2, 2.0]])
        uvr = np.asarray(geo.project_stereo(self.CAM, X))
        assert np.isclose(uvr[0, 0] - uvr[0, 2], self.CAM.bf / 2.0, atol=1e-4)

    def test_undistort_matches_cv2(self):
        cv2 = pytest.importorskip("cv2")
        cam = geo.Camera(
            fx=517.3, fy=516.5, cx=318.6, cy=255.3,
            k1=0.2624, k2=-0.9531, p1=-0.0054, p2=0.0026, k3=1.1633,
        )
        uv = rng(15).uniform([100, 100], [540, 380], size=(40, 2)).astype(np.float32)
        got = np.asarray(geo.undistort_points(cam, jnp.asarray(uv), iters=20))
        K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]])
        dist = np.array([cam.k1, cam.k2, cam.p1, cam.p2, cam.k3])
        ref = cv2.undistortPoints(uv.reshape(-1, 1, 2), K, dist, P=K).reshape(-1, 2)
        np.testing.assert_allclose(got, ref, atol=0.1)

    def test_in_image(self):
        uv = jnp.array([[0.0, 0.0], [639.5, 479.5], [-1.0, 10.0], [640.0, 10.0]])
        m = np.asarray(geo.in_image(self.CAM, uv))
        assert m.tolist() == [True, True, False, False]


def test_jit_and_vmap_compose():
    xi = jnp.asarray(rng(16).normal(size=(8, 6)).astype(np.float32))
    f = jax.jit(lambda a: geo.se3_log(geo.se3_exp(a)))
    out = jax.vmap(f)(xi[None].repeat(2, axis=0))
    np.testing.assert_allclose(np.asarray(out[0]), np.asarray(xi), atol=1e-4)
