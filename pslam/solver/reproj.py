"""Point reprojection residuals and analytic Jacobians (mono + RGB-D stereo).

Semantics follow g2o's EdgeSE3ProjectXYZ / EdgeStereoSE3ProjectXYZ
(Thirdparty/g2o/g2o/types/types_six_dof_expmap.cpp) as used by the reference's
Optimizer (Optimizer.cc:282-362): residual = observation - projection, pose
update is left-multiplicative exp(xi) @ T_cw with tangent [omega, upsilon].

Jacobians are hand-derived for the hot path and validated against jax.jacfwd
in tests/test_solver.py.

Notation: Xc = R X_w + t; for xi = [w, u], d(exp(xi) Xc)/dxi |_0 = [-[Xc]x, I].
"""

from __future__ import annotations

import jax.numpy as jnp

from pslam.geometry import Camera, se3_R, transform_points
from pslam.geometry.lie import so3_hat


def _proj_derivs(cam: Camera, Xc):
    """d(u,v)/dXc for pinhole projection. Xc: (..., 3) -> (..., 2, 3)."""
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    iz = 1.0 / z_safe
    iz2 = iz * iz
    zero = jnp.zeros_like(x)
    row_u = jnp.stack([cam.fx * iz, zero, -cam.fx * x * iz2], axis=-1)
    row_v = jnp.stack([zero, cam.fy * iz, -cam.fy * y * iz2], axis=-1)
    return jnp.stack([row_u, row_v], axis=-2)


def mono_residual_jac(cam: Camera, T_cw, X_w, obs_uv):
    """Batched mono edge: returns (r (...,2), J_pose (...,2,6), J_point (...,2,3)).

    r = obs - proj(T X); J_* = dr/d(xi, X_w).
    """
    Xc = transform_points(T_cw, X_w)
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * x / z_safe + cam.cx
    v = cam.fy * y / z_safe + cam.cy
    r = obs_uv - jnp.stack([u, v], axis=-1)

    dproj = _proj_derivs(cam, Xc)  # (..., 2, 3)
    # dXc/dxi = [-[Xc]x | I]  (xi = [omega, upsilon])
    dXc_dxi = jnp.concatenate(
        [-so3_hat(Xc), jnp.broadcast_to(jnp.eye(3, dtype=Xc.dtype), Xc.shape + (3,))],
        axis=-1,
    )  # (..., 3, 6)
    J_pose = -(dproj @ dXc_dxi)  # (..., 2, 6)
    R = se3_R(T_cw)
    J_point = -(dproj @ jnp.broadcast_to(R, Xc.shape[:-1] + (3, 3)))
    return r, J_pose, J_point


def stereo_residual_jac(cam: Camera, T_cw, X_w, obs_uvr):
    """Batched RGB-D stereo edge: r (...,3) = obs[u,v,ur] - proj_stereo(T X).

    Returns (r, J_pose (...,3,6), J_point (...,3,3)).
    """
    Xc = transform_points(T_cw, X_w)
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    iz = 1.0 / z_safe
    iz2 = iz * iz
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur = u - cam.bf * iz
    r = obs_uvr - jnp.stack([u, v, ur], axis=-1)

    zero = jnp.zeros_like(x)
    row_u = jnp.stack([cam.fx * iz, zero, -cam.fx * x * iz2], axis=-1)
    row_v = jnp.stack([zero, cam.fy * iz, -cam.fy * y * iz2], axis=-1)
    row_r = jnp.stack(
        [cam.fx * iz, zero, -cam.fx * x * iz2 + cam.bf * iz2], axis=-1
    )
    dproj = jnp.stack([row_u, row_v, row_r], axis=-2)  # (..., 3, 3)

    dXc_dxi = jnp.concatenate(
        [-so3_hat(Xc), jnp.broadcast_to(jnp.eye(3, dtype=Xc.dtype), Xc.shape + (3,))],
        axis=-1,
    )
    J_pose = -(dproj @ dXc_dxi)
    R = se3_R(T_cw)
    J_point = -(dproj @ jnp.broadcast_to(R, Xc.shape[:-1] + (3, 3)))
    return r, J_pose, J_point
