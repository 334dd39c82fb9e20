"""Structural-line (LIL) composite error terms.

Re-implements EdgeLILSE3ProjectXYZ (reference add_inc/EdgeLIL.h:210-439) in
batched JAX. The LIL landmark is the 15-d state
[P1s, P1e, P2s, P2e, X_ins] (two 3D segment endpoint pairs + their
intersection, world frame); an observation is the 8-vector
[l1 (3, normalized image-line eq), l2 (3), uv_ins (2)].

The 6-d residual (EdgeLIL.h computeError, :220-256):

    r = [ l1 . h(pi(T P1s)),  l1 . h(pi(T P1e)),
          l2 . h(pi(T P2s)),  l2 . h(pi(T P2e)),
          uv_ins - pi(T X_ins) ]

with h(u, v) = (u, v, 1) — the first four rows are signed point-to-line
distances of the projected endpoints.

Landmark parameterization: the reference's VertexLIL is declared 3-DoF over
the 15-d state, but its oplus reads a 15-d update (VertexLIL.h:23-27 — an
out-of-bounds read of g2o's 3-d update buffer) and its pose-opt Jacobian
reuses segment(9) for both line-2 endpoints (EdgeLIL.h:273-275). We
implement the *correct* 3-DoF semantics instead (SURVEY.md §7/S4): the
update translates the whole structure rigidly (all five points share one
3-d shift), which keeps landmark Hessian blocks 3x3 — the same shape as map
points, so LILs drop into the existing Schur pipeline.

Information: identity * LIL_INFO (Optimizer.cc:1970, 2320: invSigma = 0.01);
Huber delta sqrt(11.07) and chi2 gate 11.07 (Optimizer.cc:628, chi2LLIL).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from pslam.geometry import Camera, se3_R, transform_points
from pslam.geometry.lie import so3_hat

LIL_INFO = 0.01  # invSigma (Optimizer.cc:1970)
CHI2_LIL = 11.07  # chi2LLIL gate / Huber delta^2 (Optimizer.cc:628,706)
LIL_TRACK_WEIGHT = 5  # LIL matches count x5 in tracking inlier gates
# (Tracking.cc:1037, 1281-1284, 1396)


class LILPoseObs(NamedTuple):
    """Fixed-capacity LIL observations for one frame's pose solve.

    ``state``: (N, 15) world-frame [P1s, P1e, P2s, P2e, X_ins] (held fixed
    in pose-only optimization, Optimizer.cc:650 setFixed(true)).
    ``obs``: (N, 8) [l1, l2, uv_ins].
    """

    state: jnp.ndarray  # (N, 15)
    obs: jnp.ndarray  # (N, 8)
    valid: jnp.ndarray  # (N,) bool


def _proj(cam: Camera, Xc):
    z = Xc[..., 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * Xc[..., 0] / z_safe + cam.cx
    v = cam.fy * Xc[..., 1] / z_safe + cam.cy
    return jnp.stack([u, v], axis=-1)


def _dproj(cam: Camera, Xc):
    """d(u,v)/dXc: (..., 2, 3)."""
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    iz = 1.0 / z_safe
    iz2 = iz * iz
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([cam.fx * iz, zero, -cam.fx * x * iz2], axis=-1),
            jnp.stack([zero, cam.fy * iz, -cam.fy * y * iz2], axis=-1),
        ],
        axis=-2,
    )


def lil_residual_jac(cam: Camera, T_cw, state, obs):
    """Batched LIL edge terms.

    T_cw: (..., 4, 4) (broadcast against leading dims of state/obs);
    state: (..., 15); obs: (..., 8).
    Returns (r (..., 6), J_pose (..., 6, 6), J_lm (..., 6, 3), min_z (...,)).
    ``min_z`` is the minimum camera-frame depth over the five points
    (isDepthPositive, EdgeLIL.h:258-262).
    """
    pts_w = state.reshape(state.shape[:-1] + (5, 3))
    Xc = transform_points(T_cw[..., None, :, :], pts_w)  # (..., 5, 3)
    uv = _proj(cam, Xc)  # (..., 5, 2)
    dp = _dproj(cam, Xc)  # (..., 5, 2, 3)
    R = se3_R(T_cw)  # (..., 3, 3)

    l1 = obs[..., 0:3]
    l2 = obs[..., 3:6]
    uv_obs = obs[..., 6:8]

    def line_row(l, k):
        # r = l . (u, v, 1); dr/dXc = l[:2] . dproj
        r = (
            l[..., 0] * uv[..., k, 0]
            + l[..., 1] * uv[..., k, 1]
            + l[..., 2]
        )
        drdXc = (
            l[..., 0, None] * dp[..., k, 0, :]
            + l[..., 1, None] * dp[..., k, 1, :]
        )  # (..., 3)
        return r, drdXc

    r0, g0 = line_row(l1, 0)
    r1, g1 = line_row(l1, 1)
    r2, g2 = line_row(l2, 2)
    r3, g3 = line_row(l2, 3)
    r_ins = uv_obs - uv[..., 4, :]  # (..., 2)

    r = jnp.concatenate(
        [
            r0[..., None], r1[..., None], r2[..., None], r3[..., None], r_ins
        ],
        axis=-1,
    )  # (..., 6)

    # dXc/dxi = [-[Xc]x | I]; dXc/dshift = R.
    hats = so3_hat(Xc)  # (..., 5, 3, 3)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=Xc.dtype), hats.shape)
    dXc_dxi = jnp.concatenate([-hats, eye], axis=-1)  # (..., 5, 3, 6)

    def pose_row(g, k):  # g (..., 3) -> (..., 6)
        return jnp.einsum("...i,...ij->...j", g, dXc_dxi[..., k, :, :])

    Rb = jnp.broadcast_to(R[..., None, :, :], hats.shape)

    def lm_row(g, k):
        return jnp.einsum("...i,...ij->...j", g, Rb[..., k, :, :])

    J_pose = jnp.stack(
        [
            pose_row(g0, 0),
            pose_row(g1, 1),
            pose_row(g2, 2),
            pose_row(g3, 3),
        ],
        axis=-2,
    )  # (..., 4, 6)
    J_lm = jnp.stack(
        [lm_row(g0, 0), lm_row(g1, 1), lm_row(g2, 2), lm_row(g3, 3)],
        axis=-2,
    )  # (..., 4, 3)

    # Intersection rows: residual = obs - proj => J = -dproj @ dXc/d*.
    J_ins_pose = -jnp.einsum(
        "...ij,...jk->...ik", dp[..., 4, :, :], dXc_dxi[..., 4, :, :]
    )  # (..., 2, 6)
    J_ins_lm = -jnp.einsum(
        "...ij,...jk->...ik", dp[..., 4, :, :], Rb[..., 4, :, :]
    )  # (..., 2, 3)

    J_pose = jnp.concatenate([J_pose, J_ins_pose], axis=-2)  # (..., 6, 6)
    J_lm = jnp.concatenate([J_lm, J_ins_lm], axis=-2)  # (..., 6, 3)
    min_z = jnp.min(Xc[..., 2], axis=-1)
    return r, J_pose, J_lm, min_z


def lil_chi2(r):
    """chi2 = r^T (I * LIL_INFO) r."""
    return jnp.sum(r * r, axis=-1) * LIL_INFO
