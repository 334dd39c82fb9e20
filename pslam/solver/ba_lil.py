"""Local bundle adjustment with point AND structural-line (LIL) landmarks.

Extends solver/local_ba.py with the LIL blocks of
Optimizer::LocalBundleAdjustmentAndInseclines (reference
src/Optimizer.cc:2274-2346): marginalized LIL vertices with 6-d composite
edges (info I*0.01, Huber sqrt(11.07)), LM schedule 5 + 10 with the chi2
11.07 / positive-depth gate between phases (Optimizer.cc:2370-2420).

Because our LIL landmark update is a rigid 3-d translation of the 15-d
structure (see solver/lil.py), LIL Hessian blocks are 3x3 — the landmark
axis of the Schur system is simply points ++ LILs and `_solve_schur` is
reused unchanged. (MapLines are collected but get no vertices in the
reference's active BA — SURVEY.md §3.2 note — and likewise none here.)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from pslam.geometry import Camera, se3_exp
from pslam.solver.lil import CHI2_LIL, LIL_INFO, lil_residual_jac
from pslam.solver.local_ba import (
    BAProblem,
    _assemble,
    _edge_depth,
    _edge_terms,
    _solve_schur,
)
from pslam.solver.robust import CHI2_MONO, CHI2_STEREO, huber_weight


class LILBAEdges(NamedTuple):
    """Fixed-capacity LIL observation edges for local BA."""

    cam_idx: jnp.ndarray  # (El,) int32 into prob.T_cw
    lil_idx: jnp.ndarray  # (El,) int32 into lil_state
    obs: jnp.ndarray  # (El, 8) [l1, l2, uv_ins]
    valid: jnp.ndarray  # (El,) bool


def _lil_edge_terms(cam, T_all, lil_state, ledges: LILBAEdges, active, use_huber):
    T_e = T_all[ledges.cam_idx]
    st_e = lil_state[ledges.lil_idx]
    r, Jc, Jl, min_z = lil_residual_jac(cam, T_e, st_e, ledges.obs)
    chi2 = jnp.sum(r * r, axis=-1) * LIL_INFO
    w_rob = jnp.where(use_huber, huber_weight(chi2, jnp.sqrt(CHI2_LIL)), 1.0)
    a = active.astype(r.dtype)
    w_eff = w_rob * LIL_INFO * a
    cost = jnp.sum(chi2 * w_rob * a)
    return chi2, w_eff, r, Jc, Jl, min_z, cost


def _assemble_lil(ledges: LILBAEdges, n_free, n_lil, free_slot, w_eff, r, Jc, Jl):
    """LIL-edge normal-equation blocks: Hcc/bc additions + (Q,3,3) landmark
    blocks + (Q, F, 6, 3) coupling."""
    slot_e = free_slot[ledges.cam_idx]
    free_e = slot_e >= 0
    slot_safe = jnp.where(free_e, slot_e, n_free)

    w = w_eff[..., None, None]
    Hcc_e = jnp.einsum("eij,eik->ejk", Jc, Jc) * w
    Hll_e = jnp.einsum("eij,eik->ejk", Jl, Jl) * w
    Hcl_e = jnp.einsum("eij,eik->ejk", Jc, Jl) * w  # (El, 6, 3)
    bc_e = -jnp.einsum("eij,ei->ej", Jc, r) * w_eff[..., None]
    bl_e = -jnp.einsum("eij,ei->ej", Jl, r) * w_eff[..., None]

    Hcc = jnp.zeros((n_free + 1, 6, 6), Jc.dtype).at[slot_safe].add(Hcc_e)[:n_free]
    bc = jnp.zeros((n_free + 1, 6), Jc.dtype).at[slot_safe].add(bc_e)[:n_free]
    Hll = jnp.zeros((n_lil, 3, 3), Jl.dtype).at[ledges.lil_idx].add(Hll_e)
    bl = jnp.zeros((n_lil, 3), Jl.dtype).at[ledges.lil_idx].add(bl_e)
    flat = ledges.lil_idx * (n_free + 1) + slot_safe
    Gl = (
        jnp.zeros((n_lil * (n_free + 1), 6, 3), Jc.dtype)
        .at[flat]
        .add(Hcl_e)
        .reshape(n_lil, n_free + 1, 6, 3)[:, :n_free]
    )
    return Hcc, bc, Hll, bl, Gl


from functools import partial


@partial(jax.jit, static_argnames=("cam", "n_free", "schedule"))
def local_bundle_adjustment_lil(
    cam: Camera,
    prob: BAProblem,
    lil_state,  # (Q, 15)
    lil_valid,  # (Q,)
    ledges: LILBAEdges,
    n_free: int,
    schedule=(5, 10),
):
    """Joint point + LIL local BA.

    Returns (T_opt, X_opt, lil_state_opt, point_edge_inlier, lil_edge_inlier).
    """
    Q = lil_state.shape[0]

    def normal_eqs(T_all, X_all, lst, active_p, active_l, use_huber):
        _, w_p, r_p, Jc_p, Jp_p, cost_p = _edge_terms(
            cam, prob, T_all, X_all, active_p, use_huber
        )
        Hcc, bc, Hpp, bp, G = _assemble(prob, n_free, w_p, r_p, Jc_p, Jp_p)
        _, w_l, r_l, Jc_l, Jl_l, _, cost_l = _lil_edge_terms(
            cam, T_all, lst, ledges, active_l, use_huber
        )
        Hcc_l, bc_l, Hll, bl, Gl = _assemble_lil(
            ledges, n_free, Q, prob.free_slot, w_l, r_l, Jc_l, Jl_l
        )
        Hcc = Hcc + Hcc_l
        bc = bc + bc_l
        Hpp_all = jnp.concatenate([Hpp, Hll], axis=0)
        bp_all = jnp.concatenate([bp, bl], axis=0)
        G_all = jnp.concatenate([G, Gl], axis=0)
        lm_valid = jnp.concatenate([prob.point_valid, lil_valid], axis=0)
        return Hcc, bc, Hpp_all, bp_all, G_all, lm_valid, cost_p + cost_l

    def apply(T_all, X_all, lst, dx_c, dx_p):
        slot = jnp.maximum(prob.free_slot, 0)
        dx_cam = dx_c[slot] * (prob.free_slot >= 0)[..., None]
        T_new = se3_exp(dx_cam) @ T_all
        P = prob.X_w.shape[0]
        X_new = X_all + dx_p[:P]
        shift = dx_p[P:] * lil_valid[:, None]  # (Q, 3)
        lst_new = lst + jnp.tile(shift, (1, 5))
        return T_new, X_new, lst_new

    def lm_phase(T_all, X_all, lst, active_p, active_l, n_iters, use_huber):
        # One normal-equation assembly per LM iteration (the blocks at the
        # current estimate ride the carry; see solver/local_ba.py lm_phase).
        def body(carry, _):
            T_all, X_all, lst, lam, cost, blocks = carry
            Hcc, bc, Hpp, bp, G, lm_valid = blocks
            dx_c, dx_p = _solve_schur(Hcc, bc, Hpp, bp, G, lm_valid, lam)
            T_new, X_new, lst_new = apply(T_all, X_all, lst, dx_c, dx_p)
            *blocks_new, cost_new = normal_eqs(
                T_new, X_new, lst_new, active_p, active_l, use_huber
            )
            accept = cost_new < cost
            sel = lambda a, b: jnp.where(accept, a, b)  # noqa: E731
            T_n = sel(T_new, T_all)
            X_n = sel(X_new, X_all)
            l_n = sel(lst_new, lst)
            blocks_n = jax.tree_util.tree_map(sel, tuple(blocks_new), blocks)
            lam_n = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e6)
            cost_n = jnp.where(accept, cost_new, cost)
            return (T_n, X_n, l_n, lam_n, cost_n, blocks_n), None

        *blocks0, cost0 = normal_eqs(T_all, X_all, lst, active_p, active_l, use_huber)
        (T_o, X_o, l_o, *_), _ = jax.lax.scan(
            body,
            (T_all, X_all, lst, jnp.asarray(1e-4, T_all.dtype), cost0,
             tuple(blocks0)),
            None,
            length=n_iters,
        )
        return T_o, X_o, l_o

    def classify(T_all, X_all, lst):
        chi2_p, *_ = _edge_terms(cam, prob, T_all, X_all, prob.edge_valid, False)
        z = _edge_depth(prob, T_all, X_all)
        is_stereo = prob.obs[..., 2] >= 0.0
        gate = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)
        in_p = prob.edge_valid & (chi2_p <= gate) & (z > 0.0)
        chi2_l, *_, min_z, _ = _lil_edge_terms(
            cam, T_all, lst, ledges, ledges.valid, False
        )
        in_l = ledges.valid & (chi2_l <= CHI2_LIL) & (min_z > 0.0)
        return in_p, in_l

    T_all, X_all, lst = prob.T_cw, prob.X_w, lil_state
    active_p, active_l = prob.edge_valid, ledges.valid

    T_all, X_all, lst = lm_phase(
        T_all, X_all, lst, active_p, active_l, schedule[0], True
    )
    active_p, active_l = classify(T_all, X_all, lst)
    T_all, X_all, lst = lm_phase(
        T_all, X_all, lst, active_p, active_l, schedule[1], False
    )
    in_p, in_l = classify(T_all, X_all, lst)
    return T_all, X_all, lst, in_p, in_l
