"""Local bundle adjustment with Schur-complement reduction.

Re-implements Optimizer::LocalBundleAdjustmentAndInseclines (reference
src/Optimizer.cc:1968-2534) minus the LIL terms (added via solver/lil.py):

- free keyframes (1-hop covisibility) + fixed observer keyframes, all in one
  pose array; fixed cameras are pinned by zeroing their rows/cols of the
  reduced system (equivalent to g2o setFixed);
- marginalized point landmarks: per-point 3x3 Hessian blocks inverted in a
  single batched closed-form op; the reduced camera system
  ``S = Hcc - sum_p G_p Hpp_p^-1 G_p^T`` is assembled with scatter-adds over
  the observation edge list and one big einsum, then solved dense;
- LM schedule 5 iterations -> chi2 outlier gate (5.991/7.815) -> 10
  iterations, matching Optimizer.cc:2356-2420;
- returns updated poses, points, and the per-edge inlier classification that
  the host uses to erase outlier observations (Optimizer.cc:2482-2503).

The edge-list formulation is the distribution unit: `parallel/sharded_ba.py`
runs `_assemble` under shard_map with the edge arrays sharded over the mesh
and psums the (S, b) contributions across devices.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from pslam.geometry import Camera, se3_exp
from pslam.solver.linalg import inv3x3
from pslam.solver.reproj import stereo_residual_jac
from pslam.solver.robust import CHI2_MONO, CHI2_STEREO, huber_weight


class BAProblem(NamedTuple):
    """Fixed-capacity local BA problem.

    Cameras: ``T_cw`` (C,4,4) with ``free_slot`` (C,) int32 mapping each
    camera to a compact slot in [0, n_free) or -1 if fixed/padding.
    Points: ``X_w`` (P,3) with ``point_valid`` (P,).
    Edges: arrays of length E; ``obs`` rows [u, v, ur] (ur<0 = mono).
    """

    T_cw: jnp.ndarray  # (C, 4, 4)
    free_slot: jnp.ndarray  # (C,) int32; -1 = fixed
    X_w: jnp.ndarray  # (P, 3)
    point_valid: jnp.ndarray  # (P,) bool
    cam_idx: jnp.ndarray  # (E,) int32
    pt_idx: jnp.ndarray  # (E,) int32
    obs: jnp.ndarray  # (E, 3)
    inv_sigma2: jnp.ndarray  # (E,)
    edge_valid: jnp.ndarray  # (E,) bool


def _edge_onehot_cam(prob: BAProblem, dtype):
    """(E, C) 0/1 camera-selection matrix."""
    C = prob.T_cw.shape[0]
    return (
        prob.cam_idx[:, None] == jnp.arange(C, dtype=prob.cam_idx.dtype)[None, :]
    ).astype(dtype)


def _edge_onehot_pt(prob: BAProblem, dtype):
    """(E, P) 0/1 point-selection matrix.

    Loop-invariant across LM iterations (the edge list is fixed), so XLA
    hoists its construction out of the scan; both the point gather
    (contract P) and the landmark-block scatter (contract E) ride it as
    exact matmuls instead of runtime-index scatter-adds (ROADMAP design
    item 1 weighs the two on the GPU).
    """
    P = prob.X_w.shape[0]
    return (
        prob.pt_idx[:, None] == jnp.arange(P, dtype=prob.pt_idx.dtype)[None, :]
    ).astype(dtype)


_HI = jax.lax.Precision.HIGHEST


def _use_onehot() -> bool:
    import os

    return os.environ.get("PSLAM_BA_ONEHOT", "1") == "1"


def _edge_terms(cam: Camera, prob: BAProblem, T_all, X_all, active, use_huber):
    # Plain runtime-index gathers (the scatter-adds below are one-hot
    # contractions by default).
    T_e = T_all[prob.cam_idx]
    X_e = X_all[prob.pt_idx]
    r, Jc, Jp = stereo_residual_jac(cam, T_e, X_e, prob.obs)
    is_stereo = prob.obs[..., 2] >= 0.0
    row_mask = jnp.stack(
        [jnp.ones_like(is_stereo), jnp.ones_like(is_stereo), is_stereo], axis=-1
    ).astype(r.dtype)
    r = r * row_mask
    Jc = Jc * row_mask[..., None]
    Jp = Jp * row_mask[..., None]
    chi2 = jnp.sum(r * r, axis=-1) * prob.inv_sigma2
    delta = jnp.where(is_stereo, jnp.sqrt(CHI2_STEREO), jnp.sqrt(CHI2_MONO))
    w_rob = jnp.where(use_huber, huber_weight(chi2, delta), 1.0)
    a = active.astype(r.dtype)
    w_eff = w_rob * prob.inv_sigma2 * a
    cost = jnp.sum(chi2 * w_rob * a)
    return chi2, w_eff, r, Jc, Jp, cost


def _assemble(prob: BAProblem, n_free: int, w_eff, r, Jc, Jp):
    """Build the blocks of the normal equations from per-edge terms.

    Returns (Hcc (F,6,6), bc (F,6), Hpp (P,3,3), bp (P,3), G (P,F,6,3)).
    This function is pure scatter-add + einsum — the sharding cut point.
    """
    P = prob.X_w.shape[0]
    # (E,) free slot per edge (-1 if fixed), via the camera one-hot.
    slot_e = jnp.einsum(
        "ec,c->e",
        _edge_onehot_cam(prob, jnp.float32),
        prob.free_slot.astype(jnp.float32),
        precision=_HI,
    ).astype(jnp.int32)
    free_e = slot_e >= 0
    slot_safe = jnp.where(free_e, slot_e, n_free)  # overflow row is dropped

    w = w_eff[..., None, None]
    Hcc_e = jnp.einsum("eij,eik->ejk", Jc, Jc) * w  # (E, 6, 6)
    Hpp_e = jnp.einsum("eij,eik->ejk", Jp, Jp) * w  # (E, 3, 3)
    Hcp_e = jnp.einsum("eij,eik->ejk", Jc, Jp) * w  # (E, 6, 3)
    bc_e = -jnp.einsum("eij,ei->ej", Jc, r) * w_eff[..., None]
    bp_e = -jnp.einsum("eij,ei->ej", Jp, r) * w_eff[..., None]

    if _use_onehot():
        # Scatter-adds as one-hot contractions. The big
        # (E, P) one-hot rides in bf16 (0/1 exact, half the HBM traffic);
        # the scattered VALUES are bf16 too (dot_general needs matching
        # dtypes), costing ~0.4% relative error on the Hessian blocks —
        # harmless for LM (cost/accept and chi2 gates stay exact f32).
        oh_slot = (
            slot_safe[:, None]
            == jnp.arange(n_free + 1, dtype=slot_safe.dtype)[None, :]
        ).astype(Jc.dtype)  # (E, F+1) — small, stays f32
        oh_pt = _edge_onehot_pt(prob, jnp.bfloat16)  # (E, P)

        def scat_pt(vals):
            flat = vals.reshape(vals.shape[0], -1).astype(jnp.bfloat16)
            out = jax.lax.dot_general(
                oh_pt, flat, (((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.DEFAULT,
            )
            return out.reshape((oh_pt.shape[1],) + vals.shape[1:])

        Hcc = jnp.einsum("ef,ejk->fjk", oh_slot, Hcc_e, precision=_HI)[:n_free]
        bc = jnp.einsum("ef,ej->fj", oh_slot, bc_e, precision=_HI)[:n_free]
        Hpp = scat_pt(Hpp_e)
        bp = scat_pt(bp_e)

        # G[p, f] = sum_e 1[pt=p] 1[slot=f] Hcp_e: expand the small slot
        # axis first (E, F, 6, 3), then one big E-contraction.
        B = oh_slot[:, :n_free, None, None] * Hcp_e[:, None, :, :]
        G = scat_pt(B)
        return Hcc, bc, Hpp, bp, G

    Hcc = jnp.zeros((n_free + 1, 6, 6), Jc.dtype).at[slot_safe].add(Hcc_e)[:n_free]
    bc = jnp.zeros((n_free + 1, 6), Jc.dtype).at[slot_safe].add(bc_e)[:n_free]
    Hpp = jnp.zeros((P, 3, 3), Jp.dtype).at[prob.pt_idx].add(Hpp_e)
    bp = jnp.zeros((P, 3), Jp.dtype).at[prob.pt_idx].add(bp_e)
    flat = prob.pt_idx * (n_free + 1) + slot_safe
    G = (
        jnp.zeros((P * (n_free + 1), 6, 3), Jc.dtype)
        .at[flat]
        .add(Hcp_e)
        .reshape(P, n_free + 1, 6, 3)[:, :n_free]
    )
    return Hcc, bc, Hpp, bp, G


def _solve_schur(Hcc, bc, Hpp, bp, G, point_valid, lam):
    """One damped Schur step. Returns (dx_c (F,6), dx_p (P,3))."""
    F = Hcc.shape[0]
    eye3 = jnp.eye(3, dtype=Hpp.dtype)
    # LM damping on landmark blocks + lift empty/invalid blocks to identity.
    Hpp_d = Hpp + (lam * jnp.einsum("pii->p", Hpp) / 3.0 + 1e-6)[..., None, None] * eye3
    pv = point_valid[..., None, None].astype(Hpp.dtype)
    Hpp_d = Hpp_d * pv + (1.0 - pv) * eye3
    Hpp_inv = inv3x3(Hpp_d)

    M = jnp.einsum("pfij,pjk->pfik", G, Hpp_inv)  # (P, F, 6, 3)
    S_red = jnp.einsum("pfij,pgkj->fgik", M, G)  # (P-sum; the matmul-heavy step)
    eye6 = jnp.eye(6, dtype=Hcc.dtype)
    Hcc_d = Hcc + (lam * jnp.einsum("fii->f", Hcc) / 6.0 + 1e-8)[..., None, None] * eye6
    S = -S_red
    S = S.at[jnp.arange(F), jnp.arange(F)].add(Hcc_d)
    b_red = bc - jnp.einsum("pfij,pj->fi", M, bp)

    S_mat = S.transpose(0, 2, 1, 3).reshape(F * 6, F * 6)
    dx_c = jnp.linalg.solve(
        S_mat + 1e-6 * jnp.eye(F * 6, dtype=S_mat.dtype), b_red.reshape(-1)
    ).reshape(F, 6)

    # Back-substitute landmarks: dx_p = Hpp^-1 (bp - G^T dx_c).
    rhs_p = bp - jnp.einsum("pfij,fi->pj", G, dx_c)
    dx_p = jnp.einsum("pij,pj->pi", Hpp_inv, rhs_p) * point_valid[..., None]
    return dx_c, dx_p


def _apply(prob: BAProblem, T_all, X_all, dx_c, dx_p):
    slot = jnp.maximum(prob.free_slot, 0)
    dx_cam = dx_c[slot] * (prob.free_slot >= 0)[..., None]
    T_new = se3_exp(dx_cam) @ T_all
    X_new = X_all + dx_p
    return T_new, X_new


def _edge_depth(prob: BAProblem, T_all, X_all):
    """Per-edge landmark depth in its observing camera."""
    from pslam.geometry import transform_points

    Xc = transform_points(T_all[prob.cam_idx], X_all[prob.pt_idx])
    return Xc[..., 2]

from functools import partial


@partial(jax.jit, static_argnames=("cam", "n_free", "schedule"))
def local_bundle_adjustment(
    cam: Camera,
    prob: BAProblem,
    n_free: int,
    schedule=(5, 10),
):
    """Run local BA. ``n_free`` is the static number of free-camera slots.

    Returns (T_opt (C,4,4), X_opt (P,3), edge_inlier (E,), chi2 (E,)).
    """

    def lm_phase(T_all, X_all, active, n_iters, use_huber):
        # One edge-term evaluation per LM iteration: terms at the current
        # estimate ride the carry; each step solves from them, evaluates the
        # proposal once (its cost is needed anyway), and keeps the
        # proposal's terms on acceptance. The naive accept-check evaluated
        # the whole edge set twice per iteration.
        def terms_of(T, X):
            _, w_eff, r, Jc, Jp, cost = _edge_terms(
                cam, prob, T, X, active, use_huber
            )
            return (w_eff, r, Jc, Jp), cost

        def body(carry, _):
            T_all, X_all, lam, cost, terms = carry
            w_eff, r, Jc, Jp = terms
            Hcc, bc, Hpp, bp, G = _assemble(prob, n_free, w_eff, r, Jc, Jp)
            dx_c, dx_p = _solve_schur(Hcc, bc, Hpp, bp, G, prob.point_valid, lam)
            T_new, X_new = _apply(prob, T_all, X_all, dx_c, dx_p)
            terms_new, cost_new = terms_of(T_new, X_new)
            accept = cost_new < cost
            sel = lambda a, b: jnp.where(accept, a, b)  # noqa: E731
            T_next = sel(T_new, T_all)
            X_next = sel(X_new, X_all)
            terms_next = jax.tree_util.tree_map(sel, terms_new, terms)
            lam_next = jnp.clip(
                jnp.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e6
            )
            cost_next = jnp.where(accept, cost_new, cost)
            return (T_next, X_next, lam_next, cost_next, terms_next), cost_next

        terms0, cost0 = terms_of(T_all, X_all)
        (T_out, X_out, *_), _ = jax.lax.scan(
            body,
            (T_all, X_all, jnp.asarray(1e-4, T_all.dtype), cost0, terms0),
            None,
            length=n_iters,
        )
        return T_out, X_out

    T_all, X_all = prob.T_cw, prob.X_w
    active = prob.edge_valid

    # Phase 1: 5 robustified iterations (Optimizer.cc:2356-2357).
    T_all, X_all = lm_phase(T_all, X_all, active, schedule[0], True)

    # Outlier gate between phases (Optimizer.cc:2370-2414): chi2 over gate or
    # negative depth -> drop edge.
    chi2, *_ = _edge_terms(cam, prob, T_all, X_all, prob.edge_valid, False)
    z = _edge_depth(prob, T_all, X_all)
    is_stereo = prob.obs[..., 2] >= 0.0
    gate = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    active = prob.edge_valid & (chi2 <= gate) & (z > 0.0)

    # Phase 2: 10 non-robust iterations on inliers (Optimizer.cc:2419-2420).
    T_all, X_all = lm_phase(T_all, X_all, active, schedule[1], False)

    # Final classification for the host to erase outlier observations.
    chi2, *_ = _edge_terms(cam, prob, T_all, X_all, prob.edge_valid, False)
    z = _edge_depth(prob, T_all, X_all)
    inlier = prob.edge_valid & (chi2 <= gate) & (z > 0.0)
    return T_all, X_all, inlier, chi2
