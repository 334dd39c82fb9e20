"""Batched SO3 / SE3 / Sim3 Lie-group operations in pure JAX.

Replaces the reference's g2o `se3quat.h` / `sim3.h` (Thirdparty/g2o/g2o/types/)
and `Converter` (src/Converter.cc) with jit-friendly, arbitrarily-batched ops.

Conventions
-----------
- SE3 elements are stored as homogeneous ``(..., 4, 4)`` float matrices so that
  composition is a plain matmul and batching is free.
- Tangent vectors are ``xi = [omega(3), upsilon(3)]``: rotation first, then
  translation — the same ordering g2o's ``SE3Quat::exp`` uses, so solver update
  semantics mirror the reference's vertex oplus (left-multiplicative:
  ``T <- exp(xi) @ T``).
- Sim3 is the tuple ``(s, R, t)`` acting as ``x -> s * R @ x + t`` with tangent
  ``zeta = [omega(3), upsilon(3), sigma(1)]`` (g2o sim3.h ordering).

All functions broadcast over leading batch dimensions and are safe at the
small-angle limit (Taylor switches via jnp.where with safe operands).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

_EPS = 1e-8


def _safe_norm(v):
    """L2 norm with a finite gradient at v = 0 (jnp.linalg.norm NaNs there,
    which poisons jacfwd/jacrev through exp maps at the identity)."""
    return jnp.sqrt(jnp.sum(v * v, axis=-1) + 1e-24)


# Taylor switch for the trig ratio helpers. Must be large enough that the
# generic branch has no f32 catastrophic cancellation: at x=1e-4 in f32,
# 1-cos(x) evaluates to exactly 0 and (x-sin x) loses all bits. With the
# series carried to x^4 the error at the 1e-2 switch point is ~1e-16.
_TAYLOR_SWITCH = 1e-2


def _sinc(x):
    """sin(x)/x, f32-safe at 0."""
    small = jnp.abs(x) < _TAYLOR_SWITCH
    safe = jnp.where(small, 1.0, x)
    x2 = x * x
    return jnp.where(small, 1.0 - x2 / 6.0 + x2 * x2 / 120.0, jnp.sin(safe) / safe)


def _cosc(x):
    """(1 - cos(x)) / x^2, f32-safe at 0."""
    small = jnp.abs(x) < _TAYLOR_SWITCH
    safe = jnp.where(small, 1.0, x)
    x2 = x * x
    return jnp.where(
        small,
        0.5 - x2 / 24.0 + x2 * x2 / 720.0,
        (1.0 - jnp.cos(safe)) / (safe * safe),
    )


def _sincc(x):
    """(x - sin(x)) / x^3, f32-safe at 0."""
    small = jnp.abs(x) < _TAYLOR_SWITCH
    safe = jnp.where(small, 1.0, x)
    x2 = x * x
    return jnp.where(
        small,
        1.0 / 6.0 - x2 / 120.0 + x2 * x2 / 5040.0,
        (safe - jnp.sin(safe)) / (safe**3),
    )


def so3_hat(w):
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zero, -wz, wy], axis=-1),
            jnp.stack([wz, zero, -wx], axis=-1),
            jnp.stack([-wy, wx, zero], axis=-1),
        ],
        axis=-2,
    )


def so3_exp(w):
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation matrix."""
    theta = _safe_norm(w)
    K = so3_hat(w)
    K2 = K @ K
    a = _sinc(theta)[..., None, None]
    b = _cosc(theta)[..., None, None]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), K.shape)
    return eye + a * K + b * K2


def rotation_to_quaternion(R):
    """(..., 3, 3) -> (..., 4) unit quaternion [w, x, y, z], w >= 0.

    Branchless Shepperd's method: build all four candidate constructions and
    select the one keyed by the largest of (trace, R00, R11, R22); uniformly
    stable for every rotation including theta ~ pi.
    """
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = r00 + r11 + r22

    # Each candidate is 4*q_k * q (unnormalized); q_k^2 = (1 + 2*diag - tr)/4.
    qw = jnp.stack([1.0 + tr, r21 - r12, r02 - r20, r10 - r01], axis=-1)
    qx = jnp.stack([r21 - r12, 1.0 + r00 - r11 - r22, r01 + r10, r02 + r20], axis=-1)
    qy = jnp.stack([r02 - r20, r01 + r10, 1.0 + r11 - r00 - r22, r12 + r21], axis=-1)
    qz = jnp.stack([r10 - r01, r02 + r20, r12 + r21, 1.0 + r22 - r00 - r11], axis=-1)

    scores = jnp.stack([tr, r00, r11, r22], axis=-1)
    idx = jnp.argmax(scores, axis=-1)
    cand = jnp.stack([qw, qx, qy, qz], axis=-2)  # (..., 4, 4)
    q = jnp.take_along_axis(cand, idx[..., None, None].repeat(4, -1), axis=-2)[
        ..., 0, :
    ]
    q = q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), _EPS)
    sign = jnp.where(q[..., 0:1] < 0.0, -1.0, 1.0)
    return q * sign


def so3_log(R):
    """(..., 3, 3) rotation -> (..., 3) axis-angle. Safe near 0 and pi."""
    q = rotation_to_quaternion(R)
    qw = jnp.clip(q[..., 0], -1.0, 1.0)
    qv = q[..., 1:]
    norm_qv = _safe_norm(qv)
    theta = 2.0 * jnp.arctan2(norm_qv, qw)
    # w = theta * qv / |qv|; small-angle: theta ~ 2|qv|, so w ~ 2*qv*(1+...)
    small = norm_qv < 1e-6
    scale = jnp.where(small, 2.0 + theta * theta / 12.0, theta / jnp.where(small, 1.0, norm_qv))
    return qv * scale[..., None]


def _so3_left_jacobian(w):
    """V such that t = V @ upsilon in se3_exp. (..., 3) -> (..., 3, 3)."""
    theta = _safe_norm(w)
    K = so3_hat(w)
    K2 = K @ K
    b = _cosc(theta)[..., None, None]
    c = _sincc(theta)[..., None, None]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), K.shape)
    return eye + b * K + c * K2


def _so3_left_jacobian_inv(w):
    theta = _safe_norm(w)
    K = so3_hat(w)
    K2 = K @ K
    half = 0.5
    # coefficient: 1/theta^2 (1 - theta sin / (2(1-cos))). The generic form
    # divides two cancelling quantities; in f32 it blows up below theta~1e-3,
    # so switch to the series (error ~theta^6/30240) at 0.1.
    small = theta < 0.1
    safe = jnp.where(small, 1.0, theta)
    t2 = theta * theta
    coef = jnp.where(
        small,
        1.0 / 12.0 + t2 / 720.0 + t2 * t2 / 30240.0,
        (1.0 - safe * jnp.sin(safe) / (2.0 * (1.0 - jnp.cos(safe)))) / (safe * safe),
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), K.shape)
    return eye - half * K + coef[..., None, None] * K2


def se3_exp(xi):
    """(..., 6) tangent [omega, upsilon] -> (..., 4, 4) SE3 matrix."""
    w = xi[..., :3]
    u = xi[..., 3:]
    R = so3_exp(w)
    V = _so3_left_jacobian(w)
    t = jnp.einsum("...ij,...j->...i", V, u)
    return se3_from_Rt(R, t)


def se3_log(T):
    """(..., 4, 4) -> (..., 6) tangent [omega, upsilon]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    Vinv = _so3_left_jacobian_inv(w)
    u = jnp.einsum("...ij,...j->...i", Vinv, t)
    return jnp.concatenate([w, u], axis=-1)


def se3_from_Rt(R, t):
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), batch + (4,)
    )[..., None, :]
    return jnp.concatenate([top, bottom], axis=-2)


def se3_identity(batch_shape=(), dtype=jnp.float32):
    return jnp.broadcast_to(jnp.eye(4, dtype=dtype), tuple(batch_shape) + (4, 4))


def se3_R(T):
    return T[..., :3, :3]


def se3_t(T):
    return T[..., :3, 3]


def se3_inverse(T):
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return se3_from_Rt(Rt, -jnp.einsum("...ij,...j->...i", Rt, t))


def transform_points(T, X):
    """Apply SE3 ``T`` (..., 4, 4) to points ``X`` (..., N, 3) or (..., 3)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    if X.ndim >= 2 and X.shape[-2] != 3 and T.ndim + 1 <= X.ndim + 1:
        pass
    if X.ndim == T.ndim - 1:  # single point per batch element
        return jnp.einsum("...ij,...j->...i", R, X) + t
    return jnp.einsum("...ij,...nj->...ni", R, X) + t[..., None, :]


def rotate_points(T, X):
    R = T[..., :3, :3]
    if X.ndim == T.ndim - 1:
        return jnp.einsum("...ij,...j->...i", R, X)
    return jnp.einsum("...ij,...nj->...ni", R, X)


# --------------------------------------------------------------------------
# Sim3
# --------------------------------------------------------------------------


class Sim3(NamedTuple):
    """Similarity transform x -> s * R @ x + t (g2o sim3.h semantics)."""

    s: jnp.ndarray  # (...,)
    R: jnp.ndarray  # (..., 3, 3)
    t: jnp.ndarray  # (..., 3)


def sim3_identity(batch_shape=(), dtype=jnp.float32):
    b = tuple(batch_shape)
    return Sim3(
        s=jnp.ones(b, dtype=dtype),
        R=jnp.broadcast_to(jnp.eye(3, dtype=dtype), b + (3, 3)),
        t=jnp.zeros(b + (3,), dtype=dtype),
    )


def sim3_compose(a: Sim3, b: Sim3) -> Sim3:
    """(a ∘ b)(x) = a(b(x))."""
    return Sim3(
        s=a.s * b.s,
        R=a.R @ b.R,
        t=a.s[..., None] * jnp.einsum("...ij,...j->...i", a.R, b.t) + a.t,
    )


def sim3_inverse(g: Sim3) -> Sim3:
    Rt = jnp.swapaxes(g.R, -1, -2)
    s_inv = 1.0 / g.s
    return Sim3(
        s=s_inv,
        R=Rt,
        t=-s_inv[..., None] * jnp.einsum("...ij,...j->...i", Rt, g.t),
    )


def sim3_transform_points(g: Sim3, X):
    if X.ndim == g.R.ndim - 1:
        return g.s[..., None] * jnp.einsum("...ij,...j->...i", g.R, X) + g.t
    return (
        g.s[..., None, None] * jnp.einsum("...ij,...nj->...ni", g.R, X)
        + g.t[..., None, :]
    )


def sim3_from_se3(T, s=None):
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    if s is None:
        s = jnp.ones(T.shape[:-2], dtype=T.dtype)
    return Sim3(s=s, R=R, t=t)


def sim3_to_se3(g: Sim3):
    """Project Sim3 to SE3: divide translation by scale (ORB-SLAM loop-correct
    convention: [R t/s] — see reference LoopClosing.cc CorrectLoop usage)."""
    return se3_from_Rt(g.R, g.t / g.s[..., None])


def sim3_exp(zeta) -> Sim3:
    """(..., 7) tangent [omega(3), upsilon(3), sigma] -> Sim3."""
    w = zeta[..., :3]
    u = zeta[..., 3:6]
    sigma = zeta[..., 6]
    s = jnp.exp(sigma)
    R = so3_exp(w)
    theta = _safe_norm(w)
    K = so3_hat(w)
    K2 = K @ K
    eye = jnp.broadcast_to(jnp.eye(3, dtype=zeta.dtype), K.shape)

    # W matrix (Ethan Eade / g2o sim3): t = W @ u with
    # W = A*K + B*K2 + C*I, coefficients depending on (sigma, theta).
    eps = 1e-6
    sigma_safe = jnp.where(jnp.abs(sigma) < eps, 1.0, sigma)
    theta_safe = jnp.where(theta < eps, 1.0, theta)
    small_sigma = jnp.abs(sigma) < eps
    small_theta = theta < eps

    C = jnp.where(small_sigma, 1.0 + sigma / 2.0 + sigma * sigma / 6.0, (s - 1.0) / sigma_safe)

    # Generic (both non-small):
    a_gen = s * jnp.sin(theta_safe)
    b_gen = s * jnp.cos(theta_safe)
    c2 = theta_safe * theta_safe
    s2 = sigma_safe * sigma_safe
    denom = (s2 + c2)
    A_gen = (a_gen * sigma_safe + (1.0 - b_gen) * theta_safe) / (theta_safe * denom)
    B_gen = (C - ((b_gen - 1.0) * sigma_safe + a_gen * theta_safe) / denom) / c2

    # sigma ~ 0, theta general:
    A_s0 = _cosc(theta)
    B_s0 = _sincc(theta)

    # theta ~ 0, sigma general:
    A_t0 = ((sigma_safe - 1.0) * s + 1.0) / s2
    B_t0 = (s * 0.5 * s2 + s - 1.0 - sigma_safe * s) / (s2 * sigma_safe)

    A_both = 0.5 + sigma / 6.0
    B_both = 1.0 / 6.0 + sigma / 24.0

    A = jnp.where(
        small_sigma & small_theta,
        A_both,
        jnp.where(small_sigma, A_s0, jnp.where(small_theta, A_t0, A_gen)),
    )
    B = jnp.where(
        small_sigma & small_theta,
        B_both,
        jnp.where(small_sigma, B_s0, jnp.where(small_theta, B_t0, B_gen)),
    )

    W = A[..., None, None] * K + B[..., None, None] * K2 + C[..., None, None] * eye
    t = jnp.einsum("...ij,...j->...i", W, u)
    return Sim3(s=s, R=R, t=t)


def sim3_log(g: Sim3):
    """Sim3 -> (..., 7) tangent, inverse of sim3_exp (via solving W u = t)."""
    sigma = jnp.log(g.s)
    w = so3_log(g.R)
    # Rebuild W from (sigma, w) and solve for u.
    zeta_partial = jnp.concatenate(
        [w, jnp.zeros_like(w), sigma[..., None]], axis=-1
    )
    ref = sim3_exp(zeta_partial)  # t of this is W @ 0 = 0; we need W itself.
    # Recompute W directly (duplicating coefficient math would be error-prone;
    # instead apply exp to basis vectors to extract W columns).
    del ref
    basis = jnp.eye(3, dtype=w.dtype)
    cols = []
    for i in range(3):
        e = jnp.broadcast_to(basis[i], w.shape)
        z = jnp.concatenate([w, e, sigma[..., None]], axis=-1)
        cols.append(sim3_exp(z).t)
    W = jnp.stack(cols, axis=-1)  # (..., 3, 3) columns = W @ e_i
    u = jnp.linalg.solve(W, g.t[..., None])[..., 0]
    return jnp.concatenate([w, u, sigma[..., None]], axis=-1)
