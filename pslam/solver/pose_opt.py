"""Pose-only optimization (frame tracking inner loop).

Re-implements Optimizer::PoseOptimization (reference src/Optimizer.cc:239-1023)
as a jitted Levenberg-Marquardt program over a fixed-capacity masked edge list:

- mono and RGB-D stereo point edges in one array (mono edges mask the ur row);
- 4 rounds x 10 LM iterations; between rounds edges are re-classified
  inlier/outlier by the chi2 gates (5.991 mono / 7.815 stereo,
  Optimizer.cc:699-706) and outliers are excluded from the next round;
- Huber robust kernel active for the first two rounds only, matching
  e->setRobustKernel(0) at round 3 (Optimizer.cc:963 semantics);
- outliers can be re-admitted if their chi2 drops back under the gate,
  exactly like the reference's per-round re-check.

Structural-line (LIL) edges (solver/lil.py) join the same normal equations
via the optional ``lil`` argument, mirroring Optimizer.cc:619-694 (LIL
vertices fixed, info I*0.01, Huber sqrt(11.07), per-round chi2 gate 11.07).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from pslam.geometry import Camera, se3_exp
from pslam.solver.lil import (
    CHI2_LIL,
    LIL_INFO,
    LILPoseObs,
    lil_residual_jac,
)
from pslam.solver.reproj import stereo_residual_jac
from pslam.solver.robust import CHI2_MONO, CHI2_STEREO, huber_weight


class PoseObs(NamedTuple):
    """Fixed-capacity observation set for one frame's pose solve.

    ``obs`` rows are [u, v, ur]; ur < 0 marks a mono observation (reference
    Frame.mvuRight convention: -1 when no depth).
    """

    X_w: jnp.ndarray  # (N, 3) world points (fixed)
    obs: jnp.ndarray  # (N, 3) [u, v, ur]
    inv_sigma2: jnp.ndarray  # (N,) per-octave information scale
    valid: jnp.ndarray  # (N,) bool


def _edge_terms(cam: Camera, T, po: PoseObs, use_huber, active):
    """Residuals/Jacobians + weights for all edges at pose T.

    Returns (chi2 (N,), w_eff (N,), r (N,3), J (N,3,6), row_mask (N,3)).
    """
    r, J, _ = stereo_residual_jac(cam, T[None], po.X_w, po.obs)
    is_stereo = po.obs[..., 2] >= 0.0
    row_mask = jnp.stack(
        [jnp.ones_like(is_stereo), jnp.ones_like(is_stereo), is_stereo], axis=-1
    ).astype(r.dtype)
    r = r * row_mask
    chi2 = jnp.sum(r * r, axis=-1) * po.inv_sigma2
    delta = jnp.where(is_stereo, jnp.sqrt(CHI2_STEREO), jnp.sqrt(CHI2_MONO))
    w_rob = jnp.where(use_huber, huber_weight(chi2, delta), 1.0)
    w_eff = w_rob * po.inv_sigma2 * active.astype(r.dtype)
    cost = jnp.sum(chi2 * w_rob * active.astype(r.dtype))
    return chi2, w_eff, r, J, row_mask, cost


def _gn_system(w_eff, r, J, row_mask):
    Jm = J * row_mask[..., None]
    H = jnp.einsum("nij,nik,n->jk", Jm, Jm, w_eff)
    b = -jnp.einsum("nij,ni,n->j", Jm, r, w_eff)
    return H, b


def _lil_terms(cam: Camera, T, lil: LILPoseObs, use_huber, active):
    """H (6,6), b (6,), cost, chi2 (N,) for LIL edges at pose T (landmarks
    fixed — reference Optimizer.cc:650)."""
    r, J, _, _ = lil_residual_jac(cam, T[None], lil.state, lil.obs)
    chi2 = jnp.sum(r * r, axis=-1) * LIL_INFO
    delta = jnp.sqrt(CHI2_LIL)
    w_rob = jnp.where(use_huber, huber_weight(chi2, delta), 1.0)
    w_eff = w_rob * LIL_INFO * active.astype(r.dtype)
    H = jnp.einsum("nij,nik,n->jk", J, J, w_eff)
    b = -jnp.einsum("nij,ni,n->j", J, r, w_eff)
    cost = jnp.sum(chi2 * w_rob * active.astype(r.dtype))
    return H, b, cost, chi2


def pose_optimization(
    cam: Camera,
    T_init,
    po: PoseObs,
    rounds: int = 4,
    iters_per_round: int = 10,
    lil: LILPoseObs | None = None,
):
    """Optimize a single camera pose against fixed world points (+ fixed
    structural-line landmarks when ``lil`` is given — the reference adds
    EdgeLIL terms with LIL vertices held fixed, Optimizer.cc:619-694, gated
    at chi2 11.07 per round like the point edges).

    Returns (T_opt, inlier_mask (N,), chi2 (N,), lil_inlier (Nl,) | None).

    On the GPU the edge terms of each LM iteration are one Pallas launch
    (ops/pallas_pose.py): 9.9 ms against 12.3 ms per warm frame_step on an
    H100 at a 400 W limit (PERF.md). Other backends run the plain jnp path.
    """
    solve = (_pose_optimization_fused if jax.default_backend() == "gpu"
             else _pose_optimization_plain)
    return solve(cam, T_init, po, rounds, iters_per_round, lil)


def _pose_optimization_plain(
    cam: Camera,
    T_init,
    po: PoseObs,
    rounds: int,
    iters_per_round: int,
    lil: LILPoseObs | None,
):
    """The LM solve in plain jnp; XLA fuses the edge terms."""
    no_lil = lil is None

    def lm_round(T, active, lil_active, use_huber):
        # One residual/Jacobian evaluation per LM iteration: the terms at
        # the CURRENT pose are carried, each step linearizes from them,
        # evaluates the proposal once, and the proposal's terms become the
        # next carry on acceptance (the naive accept-check evaluated the
        # edge set twice per iteration — 2x the serial latency of the
        # 4x10-iteration chain, the frame hot path's dominant cost).
        def all_terms(T):
            chi2, w_eff, r, J, row_mask, cost = _edge_terms(
                cam, T, po, use_huber, active
            )
            if no_lil:
                return (r, J, row_mask, w_eff), cost
            Hx, bx, cost_x, _ = _lil_terms(cam, T, lil, use_huber, lil_active)
            return (r, J, row_mask, w_eff, Hx, bx), cost + cost_x

        def body(carry, _):
            T, lam, cost, terms = carry
            if no_lil:
                r, J, row_mask, w_eff = terms
                H, b = _gn_system(w_eff, r, J, row_mask)
            else:
                r, J, row_mask, w_eff, Hx, bx = terms
                H, b = _gn_system(w_eff, r, J, row_mask)
                H = H + Hx
                b = b + bx
            H = H + lam * jnp.diag(jnp.diag(H)) + 1e-8 * jnp.eye(6, dtype=H.dtype)
            dx = jnp.linalg.solve(H, b)
            T_new = se3_exp(dx) @ T
            terms_new, cost_new = all_terms(T_new)
            accept = cost_new < cost
            T_next = jnp.where(accept, T_new, T)
            lam_next = jnp.where(accept, lam * 0.5, lam * 4.0)
            cost_next = jnp.where(accept, cost_new, cost)
            terms_next = jax.tree_util.tree_map(
                lambda a, b: jnp.where(accept, b, a), terms, terms_new
            )
            return (T_next, jnp.clip(lam_next, 1e-10, 1e6), cost_next,
                    terms_next), None

        terms0, cost0 = all_terms(T)
        (T_out, _, _, _), _ = jax.lax.scan(
            body,
            (T, jnp.asarray(1e-4, T.dtype), cost0, terms0),
            None,
            length=iters_per_round,
        )
        return T_out

    active = po.valid
    lil_active = None if no_lil else lil.valid
    T = T_init
    for rnd in range(rounds):
        use_huber = rnd < 2
        T = lm_round(T, active, lil_active, use_huber)
        # Re-classify all valid edges for the next round (outlier gate).
        chi2, *_ = _edge_terms(cam, T, po, False, po.valid)
        is_stereo = po.obs[..., 2] >= 0.0
        gate = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)
        active = po.valid & (chi2 <= gate)
        if not no_lil:
            *_, lchi2 = _lil_terms(cam, T, lil, False, lil.valid)
            lil_active = lil.valid & (lchi2 <= CHI2_LIL)

    chi2, *_ = _edge_terms(cam, T, po, False, po.valid)
    return T, active, chi2, lil_active


def _pose_optimization_fused(
    cam: Camera,
    T_init,
    po: PoseObs,
    rounds: int,
    iters_per_round: int,
    lil: LILPoseObs | None,
    interpret: bool = False,
):
    """GPU path: residuals, Jacobians, Huber weights, the 6x6 normal
    equations and the cost of one LM iteration are one Pallas launch
    (ops/pallas_pose.py). LIL terms (a 64-slot edge set) stay in jnp and
    join the carried normal equations. ``interpret`` runs the kernel in
    Pallas's interpreter (tests on the CPU)."""
    from pslam.ops.pallas_pose import (
        pack_pose_data,
        pack_pose_params,
        pose_terms_fused,
    )

    no_lil = lil is None
    data0 = pack_pose_data(po)

    def lm_round(T, active, lil_active, use_huber):
        data = data0.at[7].set((active & po.valid).astype(jnp.float32))
        hub = jnp.asarray(1.0 if use_huber else 0.0)

        def all_terms(T):
            H, b, cost, _ = pose_terms_fused(
                data, pack_pose_params(cam, T, hub), interpret=interpret
            )
            if not no_lil:
                Hx, bx, cost_x, _ = _lil_terms(cam, T, lil, use_huber, lil_active)
                H = H + Hx
                b = b + bx
                cost = cost + cost_x
            return H, b, cost

        def body(carry, _):
            T, lam, cost, H, b = carry
            Hd = H + lam * jnp.diag(jnp.diag(H)) + 1e-8 * jnp.eye(6, dtype=H.dtype)
            dx = jnp.linalg.solve(Hd, b)
            T_new = se3_exp(dx) @ T
            H_new, b_new, cost_new = all_terms(T_new)
            accept = cost_new < cost
            sel = lambda a, b_: jnp.where(accept, a, b_)  # noqa: E731
            return (
                sel(T_new, T),
                jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e6),
                jnp.where(accept, cost_new, cost),
                sel(H_new, H), sel(b_new, b),
            ), None

        H0, b0, cost0 = all_terms(T)
        (T_out, *_), _ = jax.lax.scan(
            body,
            (T, jnp.asarray(1e-4, T.dtype), cost0, H0, b0),
            None,
            length=iters_per_round,
        )
        return T_out

    def classify(T):
        data = data0.at[7].set(po.valid.astype(jnp.float32))
        *_, chi2 = pose_terms_fused(
            data, pack_pose_params(cam, T, jnp.asarray(0.0)),
            interpret=interpret,
        )
        return chi2

    active = po.valid
    lil_active = None if no_lil else lil.valid
    T = T_init
    is_stereo = po.obs[..., 2] >= 0.0
    gate = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    for rnd in range(rounds):
        use_huber = rnd < 2
        T = lm_round(T, active, lil_active, use_huber)
        active = po.valid & (classify(T) <= gate)
        if not no_lil:
            *_, lchi2 = _lil_terms(cam, T, lil, False, lil.valid)
            lil_active = lil.valid & (lchi2 <= CHI2_LIL)

    return T, active, classify(T), lil_active
