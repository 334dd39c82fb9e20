"""Distributed local/global BA: edge-sharded assembly + point-sharded Schur.

Distribution layout (BASELINE.json north star; scaling-book recipe):

- mesh axis ``edges``: the observation edge list (cam_idx, pt_idx, obs, ...)
  is sharded along it. Edges are the data axis of BA — each device computes
  residuals/Jacobians and partial normal-equation blocks for its shard only.
- camera poses and landmark positions are replicated (small); the camera
  blocks (Hcc, bc) are ``psum``-combined (tiny), while the landmark blocks
  (Hpp, bp, G) — the payload that dominates communication — are
  ``psum_scatter``-combined so each device OWNS P/D landmark blocks: half
  the wire traffic of an all-reduce and 1/D the memory.
- the reduced camera system is assembled per device from its owned points,
  combined with one small psum ((6F)^2 floats), solved replicated, and the
  landmark back-substitution runs on owned points with one ``all_gather``
  of dx_p (P*3 floats) to restore replication.

This reuses solver/local_ba.py's math: `_edge_terms` + `_assemble` run inside
shard_map on the edge shard. ATE-relevant semantics are identical to the
single-chip path up to floating-point summation order — equivalence-tested
on the 8-device CPU mesh (tests/test_parallel.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from pslam.geometry import Camera
from pslam.solver.linalg import inv3x3
from pslam.solver.local_ba import (
    BAProblem,
    _apply,
    _assemble,
    _edge_depth,
    _edge_terms,
)
from pslam.solver.robust import CHI2_MONO, CHI2_STEREO


def make_ba_mesh(devices=None, axis: str = "edges") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    import numpy as np

    return Mesh(np.asarray(devices), (axis,))


def _edge_spec(axis: str):
    """PartitionSpec for a BAProblem: edge arrays sharded, the rest replicated."""
    return BAProblem(
        T_cw=P(),
        free_slot=P(),
        X_w=P(),
        point_valid=P(),
        cam_idx=P(axis),
        pt_idx=P(axis),
        obs=P(axis),
        inv_sigma2=P(axis),
        edge_valid=P(axis),
    )


def sharded_local_bundle_adjustment(
    cam: Camera,
    prob: BAProblem,
    n_free: int,
    mesh: Mesh,
    schedule=(5, 10),
    axis: str = "edges",
):
    """Distributed drop-in for solver.local_bundle_adjustment.

    Edge-array AND point-array lengths must be divisible by the mesh size.
    Returns (T_opt, X_opt, edge_inlier, chi2) with edge outputs sharded
    like inputs.
    """
    espec = _edge_spec(axis)
    n_dev = mesh.shape[axis]
    P_pts = prob.X_w.shape[0]
    assert P_pts % n_dev == 0, (P_pts, n_dev)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), espec, P(axis), P()),
        out_specs=(P(), P(), P(axis), P(axis), P(axis), P()),
        check_vma=False,
    )
    def assemble_shard(T_all, X_all, prob_shard, active_shard, params):
        """Per-shard partial blocks. Camera blocks all-reduced (tiny);
        landmark blocks reduce-scattered so each device owns P/D points."""
        use_huber = params[0] > 0.5
        _, w_eff, r, Jc, Jp, cost = _edge_terms(
            cam, prob_shard, T_all, X_all, active_shard, use_huber
        )
        Hcc, bc, Hpp, bp, G = _assemble(prob_shard, n_free, w_eff, r, Jc, Jp)
        Hcc, bc, cost = jax.lax.psum((Hcc, bc, cost), axis)
        Hpp = jax.lax.psum_scatter(Hpp, axis, scatter_dimension=0, tiled=True)
        bp = jax.lax.psum_scatter(bp, axis, scatter_dimension=0, tiled=True)
        G = jax.lax.psum_scatter(G, axis, scatter_dimension=0, tiled=True)
        return Hcc, bc, Hpp, bp, G, cost

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis), P(axis), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def schur_shard(Hcc, bc, Hpp_o, bp_o, G_o, point_valid, lam):
        """Point-sharded Schur step: per-device partial reduced system from
        owned landmark blocks, one small psum, replicated dense solve,
        owned back-substitution, all_gather of dx_p."""
        idx = jax.lax.axis_index(axis)
        chunk = P_pts // n_dev
        pv = jax.lax.dynamic_slice_in_dim(point_valid, idx * chunk, chunk)

        F = Hcc.shape[0]
        eye3 = jnp.eye(3, dtype=Hpp_o.dtype)
        Hpp_d = Hpp_o + (
            lam * jnp.einsum("pii->p", Hpp_o) / 3.0 + 1e-6
        )[..., None, None] * eye3
        pvf = pv[..., None, None].astype(Hpp_o.dtype)
        Hpp_d = Hpp_d * pvf + (1.0 - pvf) * eye3
        Hpp_inv = inv3x3(Hpp_d)

        M = jnp.einsum("pfij,pjk->pfik", G_o, Hpp_inv)
        S_part = jnp.einsum("pfij,pgkj->fgik", M, G_o)
        b_part = jnp.einsum("pfij,pj->fi", M, bp_o)
        S_red, b_red_sub = jax.lax.psum((S_part, b_part), axis)

        eye6 = jnp.eye(6, dtype=Hcc.dtype)
        Hcc_d = Hcc + (
            lam * jnp.einsum("fii->f", Hcc) / 6.0 + 1e-8
        )[..., None, None] * eye6
        S = -S_red
        S = S.at[jnp.arange(F), jnp.arange(F)].add(Hcc_d)
        b_red = bc - b_red_sub
        S_mat = S.transpose(0, 2, 1, 3).reshape(F * 6, F * 6)
        dx_c = jnp.linalg.solve(
            S_mat + 1e-6 * jnp.eye(F * 6, dtype=S_mat.dtype),
            b_red.reshape(-1),
        ).reshape(F, 6)

        rhs_p = bp_o - jnp.einsum("pfij,fi->pj", G_o, dx_c)
        dx_p_o = jnp.einsum("pij,pj->pi", Hpp_inv, rhs_p) * pv[..., None]
        dx_p = jax.lax.all_gather(dx_p_o, axis, axis=0, tiled=True)
        return dx_c, dx_p

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), espec),
        out_specs=(P(axis), P(axis)),
        check_vma=False,
    )
    def classify_shard(T_all, X_all, prob_shard):
        chi2, *_ = _edge_terms(
            cam, prob_shard, T_all, X_all, prob_shard.edge_valid, False
        )
        z = _edge_depth(prob_shard, T_all, X_all)
        return chi2, z

    def lm_phase(T_all, X_all, active, n_iters, use_huber):
        params = jnp.asarray([1.0 if use_huber else 0.0], jnp.float32)

        # One assembly (one reduce round) per LM iteration: blocks at the
        # current estimate ride the carry.
        def body(carry, _):
            T_all, X_all, lam, cost, blocks = carry
            Hcc, bc, Hpp_o, bp_o, G_o = blocks
            dx_c, dx_p = schur_shard(
                Hcc, bc, Hpp_o, bp_o, G_o, prob.point_valid, lam
            )
            T_new, X_new = _apply(prob, T_all, X_all, dx_c, dx_p)
            *blocks_new, cost_new = assemble_shard(
                T_new, X_new, prob, active, params
            )
            accept = cost_new < cost
            sel = lambda a, b: jnp.where(accept, a, b)  # noqa: E731
            T_next = sel(T_new, T_all)
            X_next = sel(X_new, X_all)
            blocks_next = jax.tree_util.tree_map(
                sel, tuple(blocks_new), blocks
            )
            lam_next = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e6)
            cost_next = jnp.where(accept, cost_new, cost)
            return (T_next, X_next, lam_next, cost_next, blocks_next), None

        *blocks0, cost0 = assemble_shard(T_all, X_all, prob, active, params)
        (T_out, X_out, *_), _ = jax.lax.scan(
            body,
            (T_all, X_all, jnp.asarray(1e-4, T_all.dtype), cost0,
             tuple(blocks0)),
            None,
            length=n_iters,
        )
        return T_out, X_out

    T_all, X_all = prob.T_cw, prob.X_w
    active = prob.edge_valid

    T_all, X_all = lm_phase(T_all, X_all, active, schedule[0], True)
    chi2, z = classify_shard(T_all, X_all, prob)
    is_stereo = prob.obs[..., 2] >= 0.0
    gate = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    active = prob.edge_valid & (chi2 <= gate) & (z > 0.0)
    T_all, X_all = lm_phase(T_all, X_all, active, schedule[1], False)

    chi2, z = classify_shard(T_all, X_all, prob)
    inlier = prob.edge_valid & (chi2 <= gate) & (z > 0.0)
    return T_all, X_all, inlier, chi2


def sharded_local_bundle_adjustment_lil(
    cam: Camera,
    prob: BAProblem,
    lil_state,  # (Q, 15) replicated
    lil_valid,  # (Q,)
    ledges,  # LILBAEdges, El divisible by mesh size
    n_free: int,
    mesh: Mesh,
    schedule=(5, 10),
    axis: str = "edges",
):
    """Distributed drop-in for solver.ba_lil.local_bundle_adjustment_lil
    (the flagship composite-error BA — VERDICT r3 item 4; reference
    Optimizer.cc:2274-2346).

    Sharding layout: point edges AND LIL edges ride the same ``edges`` mesh
    axis; both landmark-block families (3x3 point blocks, 3x3 LIL
    translation blocks) are psum_scatter-owned along their own landmark
    axes. The two families never concatenate — each contributes its own
    S-part to the reduced camera system (one psum), and back-substitution
    runs on owned chunks with a tiled all_gather each.

    Returns (T_opt, X_opt, lil_state_opt, point_edge_inlier, lil_edge_inlier).
    """
    from pslam.solver.ba_lil import (
        LILBAEdges,
        _assemble_lil,
        _lil_edge_terms,
    )
    from pslam.solver.lil import CHI2_LIL

    espec = _edge_spec(axis)
    lspec = LILBAEdges(cam_idx=P(axis), lil_idx=P(axis), obs=P(axis),
                       valid=P(axis))
    n_dev = mesh.shape[axis]
    P_pts = prob.X_w.shape[0]
    Q = lil_state.shape[0]
    assert P_pts % n_dev == 0, (P_pts, n_dev)
    assert Q % n_dev == 0, (Q, n_dev)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), espec, lspec, P(axis), P(axis), P()),
        out_specs=(
            P(), P(), P(axis), P(axis), P(axis),
            P(axis), P(axis), P(axis), P(),
        ),
        check_vma=False,
    )
    def assemble_shard(T_all, X_all, lst, prob_shard, ledges_shard,
                       active_p, active_l, params):
        use_huber = params[0] > 0.5
        _, w_p, r_p, Jc_p, Jp_p, cost_p = _edge_terms(
            cam, prob_shard, T_all, X_all, active_p, use_huber
        )
        Hcc, bc, Hpp, bp, G = _assemble(prob_shard, n_free, w_p, r_p, Jc_p, Jp_p)
        _, w_l, r_l, Jc_l, Jl_l, _, cost_l = _lil_edge_terms(
            cam, T_all, lst, ledges_shard, active_l, use_huber
        )
        Hcc_l, bc_l, Hll, bll, Gl = _assemble_lil(
            ledges_shard, n_free, Q, prob_shard.free_slot, w_l, r_l, Jc_l, Jl_l
        )
        Hcc, bc, cost = jax.lax.psum(
            (Hcc + Hcc_l, bc + bc_l, cost_p + cost_l), axis
        )
        scat = lambda a: jax.lax.psum_scatter(  # noqa: E731
            a, axis, scatter_dimension=0, tiled=True
        )
        return (Hcc, bc, scat(Hpp), scat(bp), scat(G),
                scat(Hll), scat(bll), scat(Gl), cost)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(), P(), P(axis), P(axis), P(axis),
            P(axis), P(axis), P(axis), P(), P(), P(),
        ),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    def schur_shard(Hcc, bc, Hpp_o, bp_o, G_o, Hll_o, bll_o, Gl_o,
                    point_valid, lv, lam):
        idx = jax.lax.axis_index(axis)

        def damp_invert(H_o, owner_valid):
            eye3 = jnp.eye(3, dtype=H_o.dtype)
            H_d = H_o + (
                lam * jnp.einsum("pii->p", H_o) / 3.0 + 1e-6
            )[..., None, None] * eye3
            ovf = owner_valid[..., None, None].astype(H_o.dtype)
            return inv3x3(H_d * ovf + (1.0 - ovf) * eye3)

        pchunk = P_pts // n_dev
        pv = jax.lax.dynamic_slice_in_dim(point_valid, idx * pchunk, pchunk)
        qchunk = Q // n_dev
        qv = jax.lax.dynamic_slice_in_dim(lv, idx * qchunk, qchunk)
        Hpp_inv = damp_invert(Hpp_o, pv)
        Hll_inv = damp_invert(Hll_o, qv)

        Mp = jnp.einsum("pfij,pjk->pfik", G_o, Hpp_inv)
        Ml = jnp.einsum("qfij,qjk->qfik", Gl_o, Hll_inv)
        S_part = (
            jnp.einsum("pfij,pgkj->fgik", Mp, G_o)
            + jnp.einsum("qfij,qgkj->fgik", Ml, Gl_o)
        )
        b_part = (
            jnp.einsum("pfij,pj->fi", Mp, bp_o)
            + jnp.einsum("qfij,qj->fi", Ml, bll_o)
        )
        S_red, b_red_sub = jax.lax.psum((S_part, b_part), axis)

        F = Hcc.shape[0]
        eye6 = jnp.eye(6, dtype=Hcc.dtype)
        Hcc_d = Hcc + (
            lam * jnp.einsum("fii->f", Hcc) / 6.0 + 1e-8
        )[..., None, None] * eye6
        S = -S_red
        S = S.at[jnp.arange(F), jnp.arange(F)].add(Hcc_d)
        b_red = bc - b_red_sub
        S_mat = S.transpose(0, 2, 1, 3).reshape(F * 6, F * 6)
        dx_c = jnp.linalg.solve(
            S_mat + 1e-6 * jnp.eye(F * 6, dtype=S_mat.dtype),
            b_red.reshape(-1),
        ).reshape(F, 6)

        rhs_p = bp_o - jnp.einsum("pfij,fi->pj", G_o, dx_c)
        dx_p_o = jnp.einsum("pij,pj->pi", Hpp_inv, rhs_p) * pv[..., None]
        rhs_l = bll_o - jnp.einsum("qfij,fi->qj", Gl_o, dx_c)
        dx_l_o = jnp.einsum("qij,qj->qi", Hll_inv, rhs_l) * qv[..., None]
        dx_p = jax.lax.all_gather(dx_p_o, axis, axis=0, tiled=True)
        dx_l = jax.lax.all_gather(dx_l_o, axis, axis=0, tiled=True)
        return dx_c, dx_p, dx_l

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), espec, lspec),
        out_specs=(P(axis), P(axis), P(axis), P(axis)),
        check_vma=False,
    )
    def classify_shard(T_all, X_all, lst, prob_shard, ledges_shard):
        chi2, *_ = _edge_terms(
            cam, prob_shard, T_all, X_all, prob_shard.edge_valid, False
        )
        z = _edge_depth(prob_shard, T_all, X_all)
        chi2_l, *_, min_z, _ = _lil_edge_terms(
            cam, T_all, lst, ledges_shard, ledges_shard.valid, False
        )
        return chi2, z, chi2_l, min_z

    def apply(T_all, X_all, lst, dx_c, dx_p, dx_l):
        T_new, X_new = _apply(prob, T_all, X_all, dx_p=dx_p, dx_c=dx_c)
        shift = dx_l * lil_valid[:, None]
        return T_new, X_new, lst + jnp.tile(shift, (1, 5))

    def lm_phase(T_all, X_all, lst, active_p, active_l, n_iters, use_huber):
        params = jnp.asarray([1.0 if use_huber else 0.0], jnp.float32)

        def body(carry, _):
            T_all, X_all, lst, lam, cost, blocks = carry
            dx_c, dx_p, dx_l = schur_shard(
                *blocks, prob.point_valid, lil_valid, lam
            )
            T_new, X_new, lst_new = apply(T_all, X_all, lst, dx_c, dx_p, dx_l)
            *blocks_new, cost_new = assemble_shard(
                T_new, X_new, lst_new, prob, ledges, active_p, active_l, params
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

        *blocks0, cost0 = assemble_shard(
            T_all, X_all, lst, prob, ledges, active_p, active_l, params
        )
        (T_o, X_o, l_o, *_), _ = jax.lax.scan(
            body,
            (T_all, X_all, lst, jnp.asarray(1e-4, T_all.dtype), cost0,
             tuple(blocks0)),
            None,
            length=n_iters,
        )
        return T_o, X_o, l_o

    T_all, X_all, lst = prob.T_cw, prob.X_w, lil_state
    active_p, active_l = prob.edge_valid, ledges.valid
    is_stereo = prob.obs[..., 2] >= 0.0
    gate = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)

    T_all, X_all, lst = lm_phase(
        T_all, X_all, lst, active_p, active_l, schedule[0], True
    )
    chi2, z, chi2_l, min_z = classify_shard(T_all, X_all, lst, prob, ledges)
    active_p = prob.edge_valid & (chi2 <= gate) & (z > 0.0)
    active_l = ledges.valid & (chi2_l <= CHI2_LIL) & (min_z > 0.0)
    T_all, X_all, lst = lm_phase(
        T_all, X_all, lst, active_p, active_l, schedule[1], False
    )
    chi2, z, chi2_l, min_z = classify_shard(T_all, X_all, lst, prob, ledges)
    in_p = prob.edge_valid & (chi2 <= gate) & (z > 0.0)
    in_l = ledges.valid & (chi2_l <= CHI2_LIL) & (min_z > 0.0)
    return T_all, X_all, lst, in_p, in_l
