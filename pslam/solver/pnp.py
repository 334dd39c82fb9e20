"""Batched 2D-3D pose RANSAC (PnP) for depth-sparse relocalization.

Replaces the role of the reference's EPnP RANSAC (src/PnPsolver.cc:165-477)
for frames whose matched features mostly fall in depth holes: the primary
relocalization solver is 3D-3D Horn alignment on depth-backprojected matches
(solver/horn.py — every RGB-D feature *usually* has depth), and this module
is the uv-only fallback (VERDICT r3 item 9).

Design: fixed-trial RANSAC where every trial solves a 6-point DLT for the
projection matrix P = [R|t] in *normalized* camera coordinates, projects all
candidates, and counts reprojection inliers — one (T, 12, 12) batched SVD +
one batched projection, no data-dependent control flow (unlike
the reference's sequential refine loop). The winner is polished downstream
by the standard LM pose optimization, which subsumes EPnP's Gauss-Newton
refine stage (PnPsolver.cc:477-556).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from pslam.geometry import Camera

N_SAMPLE = 6  # DLT minimal-ish sample (12 equations for 11 DoF)


def _dlt_pose(X, x):
    """One DLT solve: X (S, 3) world points, x (S, 2) normalized image
    coordinates -> (4, 4) T_cw with R projected onto SO(3)."""
    S = X.shape[0]
    ones = jnp.ones((S, 1), X.dtype)
    Xh = jnp.concatenate([X, ones], axis=-1)  # (S, 4)
    zero = jnp.zeros_like(Xh)
    rows_u = jnp.concatenate([Xh, zero, -x[:, :1] * Xh], axis=-1)
    rows_v = jnp.concatenate([zero, Xh, -x[:, 1:2] * Xh], axis=-1)
    A = jnp.concatenate([rows_u, rows_v], axis=0)  # (2S, 12)
    # Null-space via the smallest eigenvector of A^T A (12x12 symmetric):
    # cheaper and batch-stabler than SVD of the rectangular system.
    _, V = jnp.linalg.eigh(A.T @ A)
    p = V[:, 0]
    P = p.reshape(3, 4)
    s = jnp.linalg.norm(P[2, :3])
    P = P / jnp.where(s > 1e-12, s, 1.0)
    # Positive depth for the sample majority fixes the projective sign.
    z = Xh @ P[2]
    P = P * jnp.sign(jnp.sum(jnp.sign(z)) + 0.5)
    M = P[:, :3]
    U, _, Vt = jnp.linalg.svd(M)
    D = jnp.diag(jnp.asarray([1.0, 1.0, jnp.linalg.det(U @ Vt)], M.dtype))
    R = U @ D @ Vt
    T = jnp.eye(4, dtype=X.dtype)
    T = T.at[:3, :3].set(R).at[:3, 3].set(P[:, 3])
    return T


@partial(jax.jit, static_argnames=("cam", "n_trials"))
def pnp_ransac_2d3d(
    cam: Camera,
    X_w,  # (N, 3) world points
    uv,  # (N, 2) observed pixels
    valid,  # (N,) bool
    key,
    n_trials: int = 256,
    px_th: float = 4.0,
):
    """Fixed-budget PnP RANSAC. Returns (T_cw (4,4), inlier (N,), n_inliers).

    Matches PnPsolver::iterate's role (PnPsolver.cc:165): hypothesis from a
    minimal sample, reprojection-gated consensus, best-trial winner.
    """
    N = X_w.shape[0]
    x_n = jnp.stack(
        [(uv[:, 0] - cam.cx) / cam.fx, (uv[:, 1] - cam.cy) / cam.fy], axis=-1
    )
    # Sample valid indices with probability mass on valid entries.
    logits = jnp.where(valid, 0.0, -1e9)
    keys = jax.random.split(key, n_trials)

    def trial(k):
        idx = jax.random.categorical(k, logits, shape=(N_SAMPLE,))
        return _dlt_pose(X_w[idx], x_n[idx])

    Ts = jax.vmap(trial)(keys)  # (T, 4, 4)

    Xc = jnp.einsum("tij,nj->tni", Ts[:, :3, :3], X_w) + Ts[:, None, :3, 3]
    z = Xc[..., 2]
    zs = jnp.maximum(z, 1e-9)
    u = cam.fx * Xc[..., 0] / zs + cam.cx
    v = cam.fy * Xc[..., 1] / zs + cam.cy
    err2 = (u - uv[None, :, 0]) ** 2 + (v - uv[None, :, 1]) ** 2
    inl = (err2 <= px_th**2) & (z > 0.05) & valid[None, :]
    score = jnp.sum(inl.astype(jnp.int32), axis=1)
    best = jnp.argmax(score)
    return Ts[best], inl[best], score[best]
