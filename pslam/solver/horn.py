"""Closed-form Horn alignment + fixed-trial batched Sim3/SE3 RANSAC.

Replaces Sim3Solver (reference src/Sim3Solver.cc:37-425): the reference runs
sequential RANSAC iterations, each computing Horn's closed form on a 3-point
sample (ComputeSim3, Sim3Solver.cc:226) and counting reprojection inliers
(CheckInliers, Sim3Solver.cc:316). Here the trial axis is a batch dimension:
all hypotheses are generated and scored in one vmapped device program —
data-dependent early exit is replaced by a fixed trial budget + argmax,
which is the jit-friendly formulation (SURVEY.md §7 hard part (a)).

Also used for RGB-D relocalization: with per-feature depth the frame gives
camera-space 3D points, so pose recovery is 3D-3D alignment with fixed
scale = 1. The reference instead uses EPnP (src/PnPsolver.cc:67-1022), a
2D-3D solver it needs because its matches carry no depth; here every ORB
feature with valid depth has a camera-frame 3D point already, making the
3-point Horn alignment both simpler and better conditioned.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from pslam.geometry.camera import Camera, project


def horn_align(P, Q, fix_scale: bool = False):
    """Closed-form similarity aligning P -> Q: Q ~= s * R @ P + t.

    P, Q: (..., n, 3). Returns (s (...,), R (..., 3, 3), t (..., 3)).
    Horn 1987 quaternion method (the reference's Sim3Solver::ComputeSim3,
    Sim3Solver.cc:226-315: M = Pc^T Qc, 4x4 N matrix, principal eigenvector
    = rotation quaternion; asymmetric least-squares scale).
    """
    Pc_mean = jnp.mean(P, axis=-2, keepdims=True)
    Qc_mean = jnp.mean(Q, axis=-2, keepdims=True)
    Pc = P - Pc_mean
    Qc = Q - Qc_mean
    # M[i, j] = sum_n Pc[n, i] * Qc[n, j]
    M = jnp.einsum("...ni,...nj->...ij", Pc, Qc)
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = jnp.stack(
        [
            jnp.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
            jnp.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
            jnp.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
            jnp.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
        ],
        axis=-2,
    )
    _, vecs = jnp.linalg.eigh(N)  # ascending eigenvalues
    q = vecs[..., :, -1]  # (w, x, y, z)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = jnp.stack(
        [
            jnp.stack(
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1
            ),
            jnp.stack(
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1
            ),
            jnp.stack(
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1
            ),
        ],
        axis=-2,
    )
    RP = jnp.einsum("...ij,...nj->...ni", R, Pc)
    if fix_scale:
        s = jnp.ones(P.shape[:-2], P.dtype)
    else:
        # Asymmetric least-squares scale (Sim3Solver.cc:286-296).
        num = jnp.sum(Qc * RP, axis=(-2, -1))
        den = jnp.sum(RP * RP, axis=(-2, -1))
        s = num / jnp.maximum(den, 1e-12)
    t = Qc_mean[..., 0, :] - s[..., None] * jnp.einsum(
        "...ij,...j->...i", R, Pc_mean[..., 0, :]
    )
    return s, R, t


class Sim3RansacResult(NamedTuple):
    s12: jnp.ndarray  # scalar
    R12: jnp.ndarray  # (3, 3)
    t12: jnp.ndarray  # (3,)
    inlier: jnp.ndarray  # (N,) bool
    n_inliers: jnp.ndarray  # int32


def sim3_ransac(
    cam: Camera,
    X1,
    X2,
    uv1,
    uv2,
    inv_sigma2_1,
    inv_sigma2_2,
    valid,
    key,
    n_trials: int = 128,
    fix_scale: bool = False,
    chi2_th: float = 9.210,
) -> Sim3RansacResult:
    """Fixed-budget 3-point RANSAC for the Sim3 (or SE3) between two matched
    camera-space landmark sets (Sim3Solver::iterate, Sim3Solver.cc:140-224).

    X1/X2: (N, 3) matched landmark positions in camera-1/2 frames.
    uv1/uv2: (N, 2) their image projections. inv_sigma2_*: per-match octave
    precision. valid: (N,) mask. Inlier check reprojects X2 into image 1 via
    S12 and X1 into image 2 via S21, err2 * inv_sigma2 < chi2_th in BOTH
    (CheckInliers, Sim3Solver.cc:316-344).
    """
    N = X1.shape[0]
    n_valid = jnp.sum(valid.astype(jnp.int32))
    # Sample 3 distinct valid indices per trial: random keys, sort-by-priority
    # trick — give invalid entries -inf priority, top-3 by random priority.
    prio = jax.random.uniform(key, (n_trials, N))
    prio = jnp.where(valid[None, :], prio, -1.0)
    _, samp = jax.lax.top_k(prio, 3)  # (T, 3)

    P = X1[samp]  # (T, 3, 3): align 2 -> 1 convention S12: X1 ~ S12 * X2
    Q = X2[samp]

    s21, R21, t21 = horn_align(P, Q, fix_scale=fix_scale)  # X2 ~= s21 R21 X1 + t21

    def score(s21, R21, t21):
        # S12 = inverse of (s21, R21, t21)
        s12 = 1.0 / jnp.maximum(s21, 1e-12)
        R12 = R21.T
        t12 = -s12 * (R12 @ t21)
        X2in1 = s12 * (X2 @ R12.T) + t12
        X1in2 = s21 * (X1 @ R21.T) + t21
        e1 = uv1 - project(cam, X2in1)
        e2 = uv2 - project(cam, X1in2)
        ok = (
            valid
            & (jnp.sum(e1 * e1, -1) * inv_sigma2_1 < chi2_th)
            & (jnp.sum(e2 * e2, -1) * inv_sigma2_2 < chi2_th)
            & (X2in1[:, 2] > 0.05)
            & (X1in2[:, 2] > 0.05)
        )
        return ok, jnp.sum(ok.astype(jnp.int32))

    ok, n_in = jax.vmap(score)(s21, R21, t21)  # (T, N), (T,)
    best = jnp.argmax(n_in)
    s21b, R21b, t21b = s21[best], R21[best], t21[best]
    s12 = 1.0 / jnp.maximum(s21b, 1e-12)
    R12 = R21b.T
    t12 = -s12 * (R12 @ t21b)
    n_best = jnp.where(n_valid >= 3, n_in[best], 0)
    return Sim3RansacResult(
        s12=s12, R12=R12, t12=t12, inlier=ok[best] & (n_best > 0),
        n_inliers=n_best,
    )


def se3_ransac_3d3d(
    X_map,
    X_cam,
    valid,
    key,
    n_trials: int = 256,
    inlier_th: float = 0.06,
):
    """Fixed-budget 3-point RANSAC SE3 from world-frame points to camera-frame
    points (RGB-D relocalization pose hypothesis: depth gives the frame's 3D,
    the map gives world 3D; replaces the role of PnPsolver::iterate,
    PnPsolver.cc:165, using the extra depth channel RGB-D provides).

    Returns (T_cw (4, 4), inlier (N,), n_inliers).
    """
    N = X_map.shape[0]
    prio = jax.random.uniform(key, (n_trials, N))
    prio = jnp.where(valid[None, :], prio, -1.0)
    _, samp = jax.lax.top_k(prio, 3)

    _, R, t = horn_align(X_map[samp], X_cam[samp], fix_scale=True)

    def score(R, t):
        Xc = X_map @ R.T + t
        err = jnp.linalg.norm(Xc - X_cam, axis=-1)
        ok = valid & (err < inlier_th)
        return ok, jnp.sum(ok.astype(jnp.int32))

    ok, n_in = jax.vmap(score)(R, t)
    best = jnp.argmax(n_in)
    # Refine on inliers: weighted Horn over all points with inlier weights is
    # not closed-form friendly under masking; instead re-run Horn on the best
    # hypothesis's inliers via masked centroid math.
    w = ok[best].astype(jnp.float32)
    sw = jnp.maximum(jnp.sum(w), 3.0)
    Pm = jnp.sum(X_map * w[:, None], 0) / sw
    Qm = jnp.sum(X_cam * w[:, None], 0) / sw
    Pc = (X_map - Pm) * w[:, None]
    Qc = (X_cam - Qm) * w[:, None]
    M = Pc.T @ Qc
    # One Horn solve on the weighted covariance (reuse quaternion path by
    # feeding synthetic 3-point decomposition is messier; do SVD here).
    U, _, Vt = jnp.linalg.svd(M)
    d = jnp.sign(jnp.linalg.det(Vt.T @ U.T))
    D = jnp.diag(jnp.array([1.0, 1.0, 0.0])) + jnp.diag(
        jnp.array([0.0, 0.0, 1.0])
    ) * d
    R_ref = Vt.T @ D @ U.T
    t_ref = Qm - R_ref @ Pm
    Xc = X_map @ R_ref.T + t_ref
    ok_ref = valid & (jnp.linalg.norm(Xc - X_cam, axis=-1) < inlier_th)
    n_ref = jnp.sum(ok_ref.astype(jnp.int32))
    use_ref = n_ref >= n_in[best]
    R_out = jnp.where(use_ref, R_ref, R[best])
    t_out = jnp.where(use_ref, t_ref, t[best])
    ok_out = jnp.where(use_ref, ok_ref, ok[best])
    T = jnp.eye(4, dtype=X_map.dtype)
    T = T.at[:3, :3].set(R_out).at[:3, 3].set(t_out)
    n_valid = jnp.sum(valid.astype(jnp.int32))
    n_out = jnp.where(n_valid >= 3, jnp.maximum(n_ref, n_in[best]), 0)
    return T, ok_out & (n_out > 0), n_out
