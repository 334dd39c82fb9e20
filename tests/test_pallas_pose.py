"""Pose-optimization edge terms: the plain path (solver/pose_opt._edge_terms
+ _gn_system) against numpy finite differences, and the fused Pallas kernel
(ops/pallas_pose.py) against the plain path: in interpret mode on the CPU,
compiled at the tracking width on the GPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pslam.geometry import Camera, se3_exp
from pslam.io.problems import pose_problem
from pslam.ops.pallas_pose import (
    pack_pose_data,
    pack_pose_params,
    pose_terms_fused,
)
from pslam.solver import pose_opt
from pslam.solver.pose_opt import _edge_terms, _gn_system
from pslam.solver.robust import CHI2_MONO, CHI2_STEREO

CAM = Camera(fx=500.0, fy=505.0, cx=320.0, cy=240.0, bf=40.0)


def make_problem(seed, E=512, T_noise=(0.05, 0.2)):
    """2 px noise, 15% invalid edges, and a further 10% of the valid ones
    inactive (an outlier round's mask)."""
    rng = np.random.default_rng(seed)
    po, T = pose_problem(CAM, E, rng, noise_px=2.0, T_noise=T_noise,
                         invalid_frac=0.15)
    active = np.asarray(po.valid) & (rng.uniform(size=E) > 0.1)
    return po, T, active


def np_residual(T, X, obs):
    """Residual obs - [u, v, ur] in float64, ur row zeroed on mono edges."""
    Xc = X @ T[:3, :3].T + T[:3, 3]
    u = CAM.fx * Xc[:, 0] / Xc[:, 2] + CAM.cx
    v = CAM.fy * Xc[:, 1] / Xc[:, 2] + CAM.cy
    r = obs - np.stack([u, v, u - CAM.bf / Xc[:, 2]], axis=1)
    r[:, 2] *= obs[:, 2] >= 0
    return r


@pytest.mark.parametrize("seed,use_huber", [(2, True), (3, False)])
def test_edge_terms_match_finite_differences(seed, use_huber):
    po, T, active = make_problem(seed)
    X = np.asarray(po.X_w, np.float64)
    obs = np.asarray(po.obs, np.float64)
    inv_s2 = np.asarray(po.inv_sigma2, np.float64)
    chi2, w_eff, r, J, row_mask, cost = _edge_terms(
        CAM, jnp.asarray(T), po, use_huber, jnp.asarray(active)
    )
    H, b = _gn_system(w_eff, r, J, row_mask)

    T64 = T.astype(np.float64)
    r_np = np_residual(T64, X, obs)
    np.testing.assert_allclose(np.asarray(r), r_np, atol=2e-3)

    # Central differences of the left-multiplied update exp(dx) @ T.
    eps = 1e-3
    J_fd = np.zeros(r_np.shape + (6,))
    for k in range(6):
        dx = np.zeros(6, np.float32)
        dx[k] = eps
        Tp = np.asarray(se3_exp(jnp.asarray(dx)), np.float64) @ T64
        Tm = np.asarray(se3_exp(jnp.asarray(-dx)), np.float64) @ T64
        J_fd[..., k] = (np_residual(Tp, X, obs) - np_residual(Tm, X, obs)) / (
            2 * eps
        )
    Jm = np.asarray(J) * np.asarray(row_mask)[..., None]
    np.testing.assert_allclose(Jm, J_fd, rtol=2e-3, atol=2e-2)

    chi2_np = (r_np**2).sum(1) * inv_s2
    np.testing.assert_allclose(np.asarray(chi2), chi2_np, rtol=1e-3, atol=1e-3)
    delta = np.where(obs[:, 2] >= 0, np.sqrt(CHI2_STEREO), np.sqrt(CHI2_MONO))
    e = np.sqrt(np.maximum(chi2_np, 1e-12))
    w_rob = np.where(use_huber & (e > delta), delta / e, 1.0)
    w_np = w_rob * inv_s2 * active
    np.testing.assert_allclose(np.asarray(w_eff), w_np, rtol=1e-3, atol=1e-6)
    H_np = np.einsum("nij,nik,n->jk", J_fd, J_fd, w_np)
    b_np = -np.einsum("nij,ni,n->j", J_fd, r_np, w_np)
    np.testing.assert_allclose(np.asarray(H), H_np, rtol=5e-3,
                               atol=1e-4 * np.abs(H_np).max())
    np.testing.assert_allclose(np.asarray(b), b_np, rtol=5e-3,
                               atol=1e-3 * np.abs(b_np).max())
    np.testing.assert_allclose(float(cost), (chi2_np * w_rob * active).sum(),
                               rtol=1e-3)


@pytest.mark.parametrize("seed,use_huber", [(0, True), (1, False)])
def test_fused_terms_match_reference(seed, use_huber):
    po, T, active = make_problem(seed)
    T_j = jnp.asarray(T)
    chi2_r, w_eff, r, J, row_mask, cost_r = _edge_terms(
        CAM, T_j, po, use_huber, jnp.asarray(active)
    )
    H_r, b_r = _gn_system(w_eff, r, J, row_mask)

    data = pack_pose_data(po).at[7].set(jnp.asarray(active, jnp.float32))
    par = pack_pose_params(CAM, T_j, jnp.asarray(1.0 if use_huber else 0.0))
    H_f, b_f, cost_f, chi2_f = pose_terms_fused(data, par, interpret=True)

    np.testing.assert_allclose(np.asarray(H_f), np.asarray(H_r), rtol=2e-4,
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(b_f), np.asarray(b_r), rtol=2e-4,
                               atol=1e-2)
    np.testing.assert_allclose(float(cost_f), float(cost_r), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(chi2_f), np.asarray(chi2_r),
                               rtol=1e-4, atol=1e-4)


def fused_vs_plain_terms(seed, E, interpret):
    """Max relative error of the kernel's (H, b, cost, chi2) against the
    plain path, each over that array's largest magnitude."""
    po, T, active = make_problem(seed, E)
    T_j = jnp.asarray(T)
    chi2_r, w_eff, r, J, row_mask, cost_r = _edge_terms(
        CAM, T_j, po, True, jnp.asarray(active)
    )
    H_r, b_r = _gn_system(w_eff, r, J, row_mask)
    data = pack_pose_data(po).at[7].set(jnp.asarray(active, jnp.float32))
    got = pose_terms_fused(data, pack_pose_params(CAM, T_j, jnp.asarray(1.0)),
                           interpret=interpret)
    return [
        float(np.abs(np.asarray(a) - np.asarray(b)).max()
              / max(np.abs(np.asarray(a)).max(), 1e-30))
        for a, b in zip((H_r, b_r, cost_r, chi2_r), got)
    ]


@pytest.mark.parametrize("E", [300, 512])
def test_fused_lm_matches_plain_lm(E):
    """The fused LM loop (packing, padding to whole edge tiles, per-round
    reclassification) converges to the plain path's pose and inliers."""
    po, T, _ = make_problem(4, E, T_noise=(0.0, 0.0))
    T0 = np.asarray(se3_exp(jnp.asarray(
        np.r_[0.01, -0.02, 0.01, 0.03, -0.02, 0.05].astype(np.float32)))) @ T
    T_p, in_p, chi2_p, _ = jax.jit(
        lambda T, po: pose_opt._pose_optimization_plain(
            CAM, T, po, 4, 10, None)
    )(jnp.asarray(T0), po)
    T_f, in_f, chi2_f, _ = jax.jit(
        lambda T, po: pose_opt._pose_optimization_fused(
            CAM, T, po, 4, 10, None, interpret=True)
    )(jnp.asarray(T0), po)
    np.testing.assert_allclose(np.asarray(T_f), np.asarray(T_p), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(in_f), np.asarray(in_p))
    np.testing.assert_allclose(np.asarray(chi2_f), np.asarray(chi2_p),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("backend,path", [
    ("gpu", "_pose_optimization_fused"),
    ("cpu", "_pose_optimization_plain"),
])
def test_pose_optimization_picks_kernel_by_backend(monkeypatch, backend, path):
    """The kernel serves the GPU alone; every other backend runs the plain
    path. Both get the same arguments."""
    calls = []
    for name in ("_pose_optimization_fused", "_pose_optimization_plain"):
        monkeypatch.setattr(pose_opt, name,
                            lambda *a, name=name: calls.append((name, a)))
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    po, T, _ = make_problem(6, 64)
    pose_opt.pose_optimization(CAM, jnp.asarray(T), po, 3, 7)
    assert [(n, a[3:]) for n, a in calls] == [(path, (3, 7, None))]


@pytest.mark.gpu
@pytest.mark.parametrize("E", [4096, 1000])
def test_fused_terms_on_gpu(E):
    """Compiled kernel at the local-map width (4096 edges) and at the
    relocalization width (1000 keyframe features); chip_smoke.py runs the
    same comparison on the card."""
    assert max(fused_vs_plain_terms(5, E, interpret=False)) <= 1e-4
