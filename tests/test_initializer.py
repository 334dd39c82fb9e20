"""Monocular two-view initializer (solver/initializer.py vs the reference
src/Initializer.cc): H/F model selection, motion recovery, triangulation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pslam.solver.initializer import initialize_two_view

FX, FY, CX, CY = 500.0, 505.0, 320.0, 240.0


def _project(X, R, t):
    Xc = X @ R.T + t
    return np.stack(
        [FX * Xc[:, 0] / Xc[:, 2] + CX, FY * Xc[:, 1] / Xc[:, 2] + CY], 1
    ), Xc[:, 2]


def _make_pair(planar, seed=0, n=300, noise=0.3):
    rng = np.random.default_rng(seed)
    if planar:
        # Points on a plane z = 4 + 0.3x + 0.2y (homography case).
        xy = rng.uniform([-2.5, -2], [2.5, 2], (n, 2))
        z = 4.0 + 0.3 * xy[:, 0] + 0.2 * xy[:, 1]
        X = np.concatenate([xy, z[:, None]], 1).astype(np.float32)
    else:
        X = rng.uniform([-2.5, -2, 3], [2.5, 2, 9], (n, 3)).astype(np.float32)
    # Frame 1 at origin; frame 2 translated + slightly rotated.
    a = 0.06
    R21 = np.array(
        [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]],
        np.float32,
    )
    t21 = np.array([-0.4, 0.05, 0.02], np.float32)
    uv1, z1 = _project(X, np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    uv2, z2 = _project(X, R21, t21)
    uv1 += rng.normal(0, noise, uv1.shape)
    uv2 += rng.normal(0, noise, uv2.shape)
    valid = (z1 > 0) & (z2 > 0) & (np.abs(uv1[:, 0] - CX) < 400) & (
        np.abs(uv2[:, 0] - CX) < 400
    )
    # Outliers.
    n_out = n // 10
    uv2[:n_out] += rng.uniform(30, 120, (n_out, 2))
    return (
        jnp.asarray(uv1.astype(np.float32)),
        jnp.asarray(uv2.astype(np.float32)),
        jnp.asarray(valid),
        R21, t21, X,
    )


@pytest.mark.parametrize("planar", [False, True])
def test_recovers_motion(planar):
    uv1, uv2, valid, R_gt, t_gt, X = _make_pair(planar)
    res = initialize_two_view(
        uv1, uv2, valid, jax.random.PRNGKey(0), FX, FY, CX, CY
    )
    assert bool(res.ok), f"init failed (planar={planar}, n_good={int(res.n_good)})"
    # Model selection: planar scene -> homography, general -> fundamental.
    assert bool(res.used_H) == planar
    R = np.asarray(res.R21)
    t = np.asarray(res.t21)
    # Rotation error (degrees).
    cos_r = (np.trace(R_gt.T @ R) - 1) / 2
    assert np.degrees(np.arccos(np.clip(cos_r, -1, 1))) < 1.0
    # Translation direction (scale is unobservable in mono).
    t_dir = t_gt / np.linalg.norm(t_gt)
    assert abs(float(t_dir @ t)) > 0.995
    # Triangulated structure matches ground truth up to the global scale.
    g = np.asarray(res.triangulated)
    assert g.sum() > 150
    X1 = np.asarray(res.X1)[g]
    Xg = X[g]
    s = np.median(Xg[:, 2] / np.maximum(X1[:, 2], 1e-9))
    err = np.linalg.norm(X1 * s - Xg, axis=1)
    assert np.median(err) < 0.08, np.median(err)
