"""Monocular two-view initializer: parallel H/F RANSAC + motion recovery.

Re-implements src/Initializer.cc (the one reference source file with no
counterpart until now; 931 LoC): given matched keypoints between two frames,
fit a homography and a fundamental matrix with fixed-budget batched RANSAC
(the reference's 200 iterations, Initializer.cc:37), score both with the
symmetric-transfer chi-square scores (CheckHomography :796, CheckFundamental
:850), pick the model by RH = SH/(SH+SF) > 0.40 (:112-121), and recover
(R, t) + triangulated structure:

- F path (ReconstructF :470): E = K^T F K, the 4-way (R, t) decomposition
  (DecomposeE :909), cheirality + reprojection + parallax vote (CheckRT
  :772 semantics) over all four candidates at once.
- H path (ReconstructH :572): Faugeras SVD decomposition into the 8
  candidate motions, same vote.

Data-parallel shape: every RANSAC hypothesis and every candidate motion is a
batch row — model fits are small closed-form solves under vmap, scoring is
one (trials, N) masked reduction, and there is no data-dependent loop.

The RGB-D pipeline never calls this (StereoInitialization covers it,
Tracking.cc:555); it completes the monocular capability surface.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

CHI2_H = 5.991
CHI2_F = 3.841
SCORE_TH = 5.991  # Gamma in CheckFundamental (Initializer.cc:861)
N_TRIALS = 200  # mMaxIterations (Initializer.cc:37)


class InitResult(NamedTuple):
    ok: jnp.ndarray  # () bool
    used_H: jnp.ndarray  # () bool
    R21: jnp.ndarray  # (3, 3)
    t21: jnp.ndarray  # (3,) unit norm
    X1: jnp.ndarray  # (N, 3) points in frame-1 camera coords
    triangulated: jnp.ndarray  # (N,) bool
    n_good: jnp.ndarray  # () int32


def _normalize(uv, valid):
    """Hartley normalization (Normalize, Initializer.cc:749): zero mean,
    unit mean absolute deviation. Returns (uv_n, T (3,3))."""
    w = valid.astype(jnp.float32)
    n = jnp.maximum(jnp.sum(w), 1.0)
    mean = jnp.sum(uv * w[:, None], axis=0) / n
    d = jnp.abs(uv - mean) * w[:, None]
    md = jnp.sum(d, axis=0) / n
    s = 1.0 / jnp.maximum(md, 1e-9)
    uv_n = (uv - mean) * s
    T = jnp.array(
        [[s[0], 0.0, -mean[0] * s[0]],
         [0.0, s[1], -mean[1] * s[1]],
         [0.0, 0.0, 1.0]],
        jnp.float32,
    )
    return uv_n, T


def _dlt_h(p1, p2):
    """4-point homography DLT: p1, p2 (4, 2) -> H (3,3) with p2 ~ H p1."""
    def rows(a, b):
        x, y = a
        u, v = b
        return jnp.array(
            [
                [0.0, 0.0, 0.0, -x, -y, -1.0, v * x, v * y, v],
                [x, y, 1.0, 0.0, 0.0, 0.0, -u * x, -u * y, -u],
            ],
            jnp.float32,
        )

    A = jnp.concatenate([rows(p1[i], p2[i]) for i in range(4)], axis=0)
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    return Vt[-1].reshape(3, 3)


def _eight_point_f(p1, p2):
    """8-point fundamental: (8, 2) pairs -> rank-2 F with x2^T F x1 = 0."""
    x, y = p1[:, 0], p1[:, 1]
    u, v = p2[:, 0], p2[:, 1]
    A = jnp.stack(
        [u * x, u * y, u, v * x, v * y, v, x, y, jnp.ones_like(x)], axis=1
    )
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    F = Vt[-1].reshape(3, 3)
    U, S, Vt2 = jnp.linalg.svd(F)
    return (U * jnp.array([S[0], S[1], 0.0])) @ Vt2


def _h_transfer_chi2(H, uv1, uv2, inv_sigma2):
    """Symmetric transfer chi2 for a homography (both directions)."""
    def err(H, a, b):
        ah = jnp.concatenate([a, jnp.ones_like(a[:, :1])], axis=1)
        p = ah @ H.T
        p = p[:, :2] / jnp.where(jnp.abs(p[:, 2:]) < 1e-12, 1e-12, p[:, 2:])
        return jnp.sum((p - b) ** 2, axis=1) * inv_sigma2

    Hinv = jnp.linalg.inv(H)
    return err(H, uv1, uv2), err(Hinv, uv2, uv1)


def _f_line_chi2(F, uv1, uv2, inv_sigma2):
    """Point-to-epipolar-line chi2 in both images."""
    x1 = jnp.concatenate([uv1, jnp.ones_like(uv1[:, :1])], axis=1)
    x2 = jnp.concatenate([uv2, jnp.ones_like(uv2[:, :1])], axis=1)
    l2 = x1 @ F.T  # lines in image 2
    l1 = x2 @ F  # lines in image 1
    d2 = jnp.sum(l2 * x2, axis=1) ** 2 / jnp.maximum(
        l2[:, 0] ** 2 + l2[:, 1] ** 2, 1e-12
    )
    d1 = jnp.sum(l1 * x1, axis=1) ** 2 / jnp.maximum(
        l1[:, 0] ** 2 + l1[:, 1] ** 2, 1e-12
    )
    return d1 * inv_sigma2, d2 * inv_sigma2


def _ransac_models(key, uv1, uv2, valid, n_pick, fit_fn):
    """Sample N_TRIALS minimal sets (valid-biased) and fit models (vmap)."""
    N = uv1.shape[0]
    logits = jnp.where(valid, 0.0, -1e9)
    picks = jax.vmap(
        lambda k: jax.random.categorical(k, logits, shape=(n_pick,))
    )(jax.random.split(key, N_TRIALS))  # (T, n_pick)
    p1 = uv1[picks]  # (T, n_pick, 2)
    p2 = uv2[picks]
    return jax.vmap(fit_fn)(p1, p2)


@partial(jax.jit, static_argnames=("fx", "fy", "cx", "cy"))
def initialize_two_view(
    uv1, uv2, valid, key,
    fx: float, fy: float, cx: float, cy: float,
    sigma: float = 1.0,
    min_parallax_deg: float = 1.0,
    min_triangulated: int = 50,
) -> InitResult:
    """Full mono initialization from matched pixel coordinates.

    uv1/uv2 (N, 2) matched keypoints (frame 1 / frame 2), valid (N,) bool.
    Returns camera-2-from-camera-1 motion (R21, t21) and structure in
    frame 1, like Initializer::Initialize (Initializer.cc:44-122).
    """
    inv_s2 = jnp.float32(1.0 / sigma**2)
    K = jnp.array(
        [[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], jnp.float32
    )
    kH, kF = jax.random.split(key)

    # --- RANSAC both models on normalized coordinates ----------------------
    uv1n, T1 = _normalize(uv1, valid)
    uv2n, T2 = _normalize(uv2, valid)
    T2inv = jnp.linalg.inv(T2)

    Hs_n = _ransac_models(kH, uv1n, uv2n, valid, 4, _dlt_h)
    Fs_n = _ransac_models(kF, uv1n, uv2n, valid, 8, _eight_point_f)
    Hs = jnp.einsum("ij,tjk,kl->til", T2inv, Hs_n, T1)
    Fs = jnp.einsum("ji,tjk,kl->til", T2, Fs_n, T1)

    w = valid.astype(jnp.float32)

    def score_h(H):
        c1, c2 = _h_transfer_chi2(H, uv1, uv2, inv_s2)
        in1 = (c1 < CHI2_H) & (c2 < CHI2_H)
        s = jnp.where(c1 < CHI2_H, CHI2_H - c1, 0.0) + jnp.where(
            c2 < CHI2_H, CHI2_H - c2, 0.0
        )
        return jnp.sum(s * w), in1 & valid

    def score_f(F):
        c1, c2 = _f_line_chi2(F, uv1, uv2, inv_s2)
        in1 = (c1 < CHI2_F) & (c2 < CHI2_F)
        s = jnp.where(c1 < CHI2_F, SCORE_TH - c1, 0.0) + jnp.where(
            c2 < CHI2_F, SCORE_TH - c2, 0.0
        )
        return jnp.sum(s * w), in1 & valid

    sH, inH = jax.vmap(score_h)(Hs)
    sF, inF = jax.vmap(score_f)(Fs)
    bh = jnp.argmax(sH)
    bf = jnp.argmax(sF)
    SH, SF = sH[bh], sF[bf]
    H_best, H_in = Hs[bh], inH[bh]
    F_best, F_in = Fs[bf], inF[bf]

    # Refit each winning model on ALL of its inliers (weighted normalized
    # DLT): a noisy minimal sample leaves the translation direction several
    # degrees off; the all-inlier least-squares model recovers it.
    def _wls_nullvec(A, w):
        M = jnp.einsum("ni,nj,n->ij", A, A, w)
        _, V = jnp.linalg.eigh(M)
        return V[:, 0]

    def refit_h(mask):
        wm = mask.astype(jnp.float32)
        x, y = uv1n[:, 0], uv1n[:, 1]
        u, v = uv2n[:, 0], uv2n[:, 1]
        zero = jnp.zeros_like(x)
        one = jnp.ones_like(x)
        A1 = jnp.stack(
            [zero, zero, zero, -x, -y, -one, v * x, v * y, v], axis=1
        )
        A2 = jnp.stack(
            [x, y, one, zero, zero, zero, -u * x, -u * y, -u], axis=1
        )
        A = jnp.concatenate([A1, A2], axis=0)
        h = _wls_nullvec(A, jnp.concatenate([wm, wm]))
        return T2inv @ h.reshape(3, 3) @ T1

    def refit_f(mask):
        wm = mask.astype(jnp.float32)
        x, y = uv1n[:, 0], uv1n[:, 1]
        u, v = uv2n[:, 0], uv2n[:, 1]
        A = jnp.stack(
            [u * x, u * y, u, v * x, v * y, v, x, y, jnp.ones_like(x)],
            axis=1,
        )
        F = _wls_nullvec(A, wm).reshape(3, 3)
        U, S, Vt2 = jnp.linalg.svd(F)
        F = (U * jnp.array([S[0], S[1], 0.0])) @ Vt2
        return T2.T @ F @ T1

    H_best = refit_h(H_in)
    F_best = refit_f(F_in)
    _, H_in = score_h(H_best)
    _, F_in = score_f(F_best)

    RH = SH / jnp.maximum(SH + SF, 1e-9)
    use_H = RH > 0.40  # Initializer.cc:115

    # --- candidate motions -------------------------------------------------
    # F path: E = K^T F K -> 4 candidates (DecomposeE, Initializer.cc:909).
    E = K.T @ F_best @ K
    U, _, Vt = jnp.linalg.svd(E)
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                  jnp.float32)
    t_e = U[:, 2] / jnp.maximum(jnp.linalg.norm(U[:, 2]), 1e-9)

    def fix_det(R):
        return R * jnp.sign(jnp.linalg.det(R))

    R1e = fix_det(U @ W @ Vt)
    R2e = fix_det(U @ W.T @ Vt)
    cands_F = (
        jnp.stack([R1e, R1e, R2e, R2e]),
        jnp.stack([t_e, -t_e, t_e, -t_e]),
    )

    # H path: Faugeras decomposition of A = K^-1 H K (ReconstructH :572).
    Kinv = jnp.linalg.inv(K)
    A = Kinv @ H_best @ K
    Ua, d, Vta = jnp.linalg.svd(A)
    Va = Vta.T
    s_det = jnp.linalg.det(Ua) * jnp.linalg.det(Va)
    d1, d2, d3 = d[0], d[1], d[2]
    denom = jnp.maximum(d1 * d1 - d3 * d3, 1e-12)
    aux1 = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) / denom, 0.0))
    aux3 = jnp.sqrt(jnp.maximum((d2 * d2 - d3 * d3) / denom, 0.0))
    aux_st = jnp.sqrt(
        jnp.maximum(
            (d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0
        )
    ) / jnp.maximum((d1 + d3) * d2, 1e-12)
    aux_st2 = jnp.sqrt(
        jnp.maximum(
            (d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0
        )
    ) / jnp.maximum((d1 - d3) * d2, 1e-12)

    Rs_h, ts_h = [], []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            # d' = d2 case (Initializer.cc:611-641)
            ct = (d2 * d2 + d1 * d3) / jnp.maximum((d1 + d3) * d2, 1e-12)
            st = e1 * e3 * aux_st
            Rp = jnp.array(
                [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
                jnp.float32,
            )
            Rp = Rp.at[0, 0].set(ct).at[0, 2].set(-st)
            Rp = Rp.at[2, 0].set(st).at[2, 2].set(ct)
            tp = jnp.array([e1 * aux1, 0.0, -e3 * aux3], jnp.float32) * (
                d1 - d3
            )
            Rs_h.append(s_det * (Ua @ Rp @ Vta))
            ts_h.append(Ua @ tp)
            # d' = -d2 case (:643-673)
            cph = (d1 * d3 - d2 * d2) / jnp.maximum((d1 - d3) * d2, 1e-12)
            sph = e1 * e3 * aux_st2
            Rn = jnp.array(
                [[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, 1.0]],
                jnp.float32,
            )
            Rn = Rn.at[0, 0].set(cph).at[0, 2].set(sph)
            Rn = Rn.at[2, 0].set(sph).at[2, 2].set(-cph)
            tn = jnp.array([e1 * aux1, 0.0, e3 * aux3], jnp.float32) * (
                d1 + d3
            )
            Rs_h.append(s_det * (Ua @ Rn @ Vta))
            ts_h.append(Ua @ tn)
    cands_H = (jnp.stack(Rs_h), jnp.stack(ts_h))

    # Evaluate the two candidate sets separately; select by use_H at the end.
    inliers = jnp.where(use_H, H_in, F_in)

    def check_rt(R, t):
        """CheckRT (Initializer.cc:772): triangulate all inlier pairs,
        count cheirality+reprojection survivors, measure parallax."""
        tn = t / jnp.maximum(jnp.linalg.norm(t), 1e-9)
        # Linear triangulation in normalized camera coords.
        x1 = jnp.stack(
            [(uv1[:, 0] - cx) / fx, (uv1[:, 1] - cy) / fy], axis=1
        )
        x2 = jnp.stack(
            [(uv2[:, 0] - cx) / fx, (uv2[:, 1] - cy) / fy], axis=1
        )
        # DLT rows for P1 = [I|0], P2 = [R|t].
        P2 = jnp.concatenate([R, tn[:, None]], axis=1)

        def tri(a, b):
            A = jnp.stack(
                [
                    jnp.array([1.0, 0.0, -a[0], 0.0]) * 1.0,
                    jnp.array([0.0, 1.0, -a[1], 0.0]) * 1.0,
                    jnp.array([P2[0, 0] - b[0] * P2[2, 0],
                               P2[0, 1] - b[0] * P2[2, 1],
                               P2[0, 2] - b[0] * P2[2, 2],
                               P2[0, 3] - b[0] * P2[2, 3]]),
                    jnp.array([P2[1, 0] - b[1] * P2[2, 0],
                               P2[1, 1] - b[1] * P2[2, 1],
                               P2[1, 2] - b[1] * P2[2, 2],
                               P2[1, 3] - b[1] * P2[2, 3]]),
                ]
            )
            _, _, Vt = jnp.linalg.svd(A)
            X = Vt[-1]
            return X[:3] / jnp.where(
                jnp.abs(X[3]) < 1e-12, 1e-12, X[3]
            )

        X1 = jax.vmap(tri)(x1, x2)  # frame-1 coords
        z1 = X1[:, 2]
        X2 = X1 @ R.T + tn
        z2 = X2[:, 2]
        # Parallax.
        n1 = X1
        n2 = X1 - (-R.T @ tn)
        cosp = jnp.sum(n1 * n2, axis=1) / jnp.maximum(
            jnp.linalg.norm(n1, axis=1) * jnp.linalg.norm(n2, axis=1), 1e-9
        )
        # Reprojection gates (4 sigma^2, Initializer.cc:831).
        u1p = fx * X1[:, 0] / jnp.maximum(z1, 1e-9) + cx
        v1p = fy * X1[:, 1] / jnp.maximum(z1, 1e-9) + cy
        e1 = (u1p - uv1[:, 0]) ** 2 + (v1p - uv1[:, 1]) ** 2
        u2p = fx * X2[:, 0] / jnp.maximum(z2, 1e-9) + cx
        v2p = fy * X2[:, 1] / jnp.maximum(z2, 1e-9) + cy
        e2 = (u2p - uv2[:, 0]) ** 2 + (v2p - uv2[:, 1]) ** 2
        good = (
            inliers
            & (z1 > 0)
            & (z2 > 0)
            & (cosp < 0.99998)
            & (e1 < 4.0 / inv_s2)
            & (e2 < 4.0 / inv_s2)
        )
        # Parallax at the 50th-best point (the reference takes the 50th
        # smallest; a masked quantile suffices behaviorally).
        cos_masked = jnp.where(good, cosp, 1.0)
        n_good = jnp.sum(good.astype(jnp.int32))
        cos_sorted = jnp.sort(cos_masked)
        idx50 = jnp.minimum(49, jnp.maximum(n_good - 1, 0))
        parallax_deg = jnp.degrees(
            jnp.arccos(jnp.clip(cos_sorted[idx50], -1.0, 1.0))
        )
        return n_good, parallax_deg, X1, good

    def eval_set(Rs, ts):
        return jax.vmap(check_rt)(Rs, ts)

    nF, parF, XF, goodF = eval_set(*cands_F)
    nH, parH, XH, goodH = eval_set(*cands_H)

    def pick(ns, pars, Xs, goods, Rs, ts):
        best = jnp.argmax(ns)
        n_best = ns[best]
        # Reference accept: clear winner, enough parallax, enough points,
        # and > 90% of the inlier count (Initializer.cc:550-566, 721).
        second = jnp.sort(ns)[-2]
        n_inl = jnp.sum(inliers.astype(jnp.int32))
        ok = (
            (second < 0.75 * n_best)
            & (pars[best] > min_parallax_deg)
            & (n_best > min_triangulated)
            & (n_best > 0.9 * n_inl)
        )
        return ok, Rs[best], ts[best], Xs[best], goods[best], n_best

    okF, RF, tF, X1F, gF, ngF = pick(nF, parF, XF, goodF, *cands_F)
    okH, RH_, tH, X1H, gH, ngH = pick(nH, parH, XH, goodH, *cands_H)

    sel = lambda a, b: jnp.where(use_H, a, b)  # noqa: E731
    return InitResult(
        ok=jnp.where(use_H, okH, okF),
        used_H=use_H,
        R21=sel(RH_, RF),
        t21=sel(tH, tF) / jnp.maximum(
            jnp.linalg.norm(sel(tH, tF)), 1e-9
        ),
        X1=sel(X1H, X1F),
        triangulated=sel(gH, gF),
        n_good=jnp.where(use_H, ngH, ngF).astype(jnp.int32),
    )
