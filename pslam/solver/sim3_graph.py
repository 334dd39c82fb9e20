"""Sim3 relative-pose optimization + essential-graph (Sim3 pose graph).

Re-implements the loop-closing numerics of the reference:

- ``optimize_sim3``: Optimizer::OptimizeSim3 (src/Optimizer.cc:2801-2999) —
  GN/LM on the relative Sim3 between two keyframes with bidirectional
  reprojection residuals, Huber, chi2=10 outlier gate between phases
  (5 iterations -> gate -> 10 more, Optimizer.cc:2924-2957).
- ``optimize_essential_graph``: Optimizer::OptimizeEssentialGraph
  (src/Optimizer.cc:2536-2799) — Sim3 pose graph over all keyframes
  (spanning tree + covisibility weight>=100 + loop edges), g2o
  BlockSolver_7_3 replaced by a dense (7K, 7K) damped GN solve: per-edge
  7x14 Jacobians come from one vmapped jacfwd (autodiff replaces g2o's
  numeric/analytic EdgeSim3 Jacobians), blocks scatter-add into a (K, K, 7, 7)
  lattice, and the solve is one Cholesky-sized dense op — small at K <= a
  few hundred keyframes.

Both are jitted with fixed capacities and validity masks (SURVEY.md §7).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from pslam.geometry.camera import Camera, project
from pslam.geometry.lie import (
    Sim3,
    sim3_compose,
    sim3_exp,
    sim3_inverse,
    sim3_log,
    sim3_transform_points,
)
from pslam.solver.robust import huber_weight

CHI2_SIM3 = 10.0  # th2 in OptimizeSim3 (Optimizer.cc:2801 signature)


# ---------------------------------------------------------------------------
# OptimizeSim3
# ---------------------------------------------------------------------------


class Sim3OptResult(NamedTuple):
    g12: Sim3
    inlier: jnp.ndarray  # (N,) bool
    n_inliers: jnp.ndarray  # () int32


def _sim3_residuals(cam: Camera, g12: Sim3, X1, X2, uv1, uv2):
    """Bidirectional reprojection residuals (N, 4): image-1 error of
    g12-mapped X2 and image-2 error of g21-mapped X1 (EdgeSim3ProjectXYZ /
    EdgeInverseSim3ProjectXYZ semantics)."""
    g21 = sim3_inverse(g12)
    X2in1 = sim3_transform_points(g12, X2)
    X1in2 = sim3_transform_points(g21, X1)
    e1 = uv1 - project(cam, X2in1)
    e2 = uv2 - project(cam, X1in2)
    return jnp.concatenate([e1, e2], axis=-1)


@partial(jax.jit, static_argnames=("cam", "fix_scale", "schedule"))
def optimize_sim3(
    cam: Camera,
    g12_init: Sim3,
    X1,
    X2,
    uv1,
    uv2,
    inv_sigma2_1,
    inv_sigma2_2,
    valid,
    fix_scale: bool = False,
    schedule=(5, 10),
) -> Sim3OptResult:
    """LM on the relative Sim3 (7-DoF; 6 when fix_scale). X1/X2 are matched
    landmark positions in the two camera frames, uv1/uv2 their observations.

    Mirrors Optimizer::OptimizeSim3's two-phase schedule with the chi2 > 10
    edge gate in both directions (Optimizer.cc:2924-2946)."""
    dtype = X1.dtype

    def edge_chi2(g12):
        r = _sim3_residuals(cam, g12, X1, X2, uv1, uv2)
        chi2_1 = jnp.sum(r[:, :2] ** 2, -1) * inv_sigma2_1
        chi2_2 = jnp.sum(r[:, 2:] ** 2, -1) * inv_sigma2_2
        return r, chi2_1, chi2_2

    def cost_terms(g12, active, use_huber):
        r, chi2_1, chi2_2 = edge_chi2(g12)
        delta = jnp.sqrt(CHI2_SIM3)
        w1 = jnp.where(use_huber, huber_weight(chi2_1, delta), 1.0)
        w2 = jnp.where(use_huber, huber_weight(chi2_2, delta), 1.0)
        a = active.astype(dtype)
        cost = jnp.sum((chi2_1 * w1 + chi2_2 * w2) * a)
        # Per-residual-row weights (N, 4).
        w_rows = jnp.concatenate(
            [
                (w1 * inv_sigma2_1 * a)[:, None].repeat(2, 1),
                (w2 * inv_sigma2_2 * a)[:, None].repeat(2, 1),
            ],
            axis=-1,
        )
        return r, w_rows, cost

    def res_of_delta(delta, g12):
        g_new = sim3_compose(sim3_exp(delta), g12)
        return _sim3_residuals(cam, g_new, X1, X2, uv1, uv2)

    def lm_phase(g12, active, n_iters, use_huber):
        def body(carry, _):
            g12, lam, cost = carry
            r, w_rows, _ = cost_terms(g12, active, use_huber)
            J = jax.jacfwd(res_of_delta)(jnp.zeros(7, dtype), g12)  # (N, 4, 7)
            H = jnp.einsum("nri,nrj,nr->ij", J, J, w_rows)
            b = -jnp.einsum("nri,nr,nr->i", J, r, w_rows)
            if fix_scale:
                # Pin the sigma (scale) tangent component (VertexSim3Expmap
                # _fix_scale): unit row/col, zero rhs.
                H = H.at[6, :].set(0.0).at[:, 6].set(0.0).at[6, 6].set(1.0)
                b = b.at[6].set(0.0)
            H = H + lam * jnp.diag(jnp.diag(H)) + 1e-8 * jnp.eye(7, dtype=dtype)
            dx = jnp.linalg.solve(H, b)
            g_new = sim3_compose(sim3_exp(dx), g12)
            *_, cost_new = cost_terms(g_new, active, use_huber)
            accept = cost_new < cost
            g_next = jax.tree.map(
                lambda a_, b_: jnp.where(accept, a_, b_), g_new, g12
            )
            lam_next = jnp.clip(
                jnp.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e6
            )
            return (g_next, lam_next, jnp.where(accept, cost_new, cost)), None

        *_, cost0 = cost_terms(g12, active, use_huber)
        (g_out, _, _), _ = jax.lax.scan(
            body, (g12, jnp.asarray(1e-4, dtype), cost0), None, length=n_iters
        )
        return g_out

    active = valid
    g12 = g12_init
    g12 = lm_phase(g12, active, schedule[0], True)
    _, c1, c2 = edge_chi2(g12)
    active = valid & (c1 <= CHI2_SIM3) & (c2 <= CHI2_SIM3)
    g12 = lm_phase(g12, active, schedule[1], False)
    _, c1, c2 = edge_chi2(g12)
    inlier = valid & (c1 <= CHI2_SIM3) & (c2 <= CHI2_SIM3)
    return Sim3OptResult(
        g12=g12, inlier=inlier, n_inliers=jnp.sum(inlier.astype(jnp.int32))
    )


# ---------------------------------------------------------------------------
# OptimizeEssentialGraph
# ---------------------------------------------------------------------------


class PoseGraphProblem(NamedTuple):
    """Fixed-capacity Sim3 pose graph.

    Vertices: (K,) Sim3 (world->camera, Scw). Edges carry the relative
    measurement S_ji with error log(S_ji * S_i * S_j^-1) (g2o EdgeSim3).
    """

    S: Sim3  # vertex estimates: s (K,), R (K,3,3), t (K,3)
    fixed: jnp.ndarray  # (K,) bool — loop KF (Optimizer.cc:2594)
    vertex_valid: jnp.ndarray  # (K,) bool
    e_i: jnp.ndarray  # (E,) int32
    e_j: jnp.ndarray  # (E,) int32
    e_Sji: Sim3  # measurements: s (E,), R (E,3,3), t (E,3)
    e_valid: jnp.ndarray  # (E,) bool


def _edge_error(Si: Sim3, Sj: Sim3, Sji: Sim3):
    return sim3_log(sim3_compose(Sji, sim3_compose(Si, sim3_inverse(Sj))))


def _edge_error_delta(d_i, d_j, Si, Sj, Sji):
    Si_new = sim3_compose(sim3_exp(d_i), Si)
    Sj_new = sim3_compose(sim3_exp(d_j), Sj)
    return _edge_error(Si_new, Sj_new, Sji)


@partial(jax.jit, static_argnames=("n_iters",))
def optimize_essential_graph(
    prob: PoseGraphProblem, n_iters: int = 20
) -> Sim3:
    """Damped GN on the Sim3 pose graph (Optimizer.cc:2536-2799; the
    reference runs optimizer.optimize(20) at Optimizer.cc:2755).

    Returns the optimized vertex Sim3s (corrected Scw per keyframe).
    """
    K = prob.fixed.shape[0]
    dtype = prob.S.t.dtype
    free = prob.vertex_valid & ~prob.fixed

    jac_fn = jax.vmap(
        jax.jacfwd(_edge_error_delta, argnums=(0, 1)),
        in_axes=(None, None, 0, 0, 0),
    )

    def step(S, lam):
        Si = jax.tree.map(lambda a: a[prob.e_i], S)
        Sj = jax.tree.map(lambda a: a[prob.e_j], S)
        r = jax.vmap(_edge_error)(Si, Sj, prob.e_Sji)  # (E, 7)
        Ji, Jj = jac_fn(
            jnp.zeros(7, dtype), jnp.zeros(7, dtype), Si, Sj, prob.e_Sji
        )  # (E, 7, 7) each
        w = prob.e_valid.astype(dtype)
        cost = jnp.sum(jnp.sum(r * r, -1) * w)

        # Assemble block Hessian on a (K, K, 7, 7) lattice.
        Hii = jnp.einsum("eri,erj,e->eij", Ji, Ji, w)
        Hjj = jnp.einsum("eri,erj,e->eij", Jj, Jj, w)
        Hij = jnp.einsum("eri,erj,e->eij", Ji, Jj, w)
        bi = -jnp.einsum("eri,er,e->ei", Ji, r, w)
        bj = -jnp.einsum("eri,er,e->ei", Jj, r, w)

        H = jnp.zeros((K, K, 7, 7), dtype)
        H = H.at[prob.e_i, prob.e_i].add(Hii)
        H = H.at[prob.e_j, prob.e_j].add(Hjj)
        H = H.at[prob.e_i, prob.e_j].add(Hij)
        H = H.at[prob.e_j, prob.e_i].add(jnp.swapaxes(Hij, -1, -2))
        b = jnp.zeros((K, 7), dtype)
        b = b.at[prob.e_i].add(bi)
        b = b.at[prob.e_j].add(bj)

        # Pin fixed/invalid vertices: identity rows/cols, zero rhs.
        fm = free.astype(dtype)
        H = H * fm[:, None, None, None] * fm[None, :, None, None]
        eye7 = jnp.eye(7, dtype=dtype)
        diag_fix = (1.0 - fm)[:, None, None] * eye7[None]
        H = H.at[jnp.arange(K), jnp.arange(K)].add(diag_fix)
        b = b * fm[:, None]

        Hm = H.transpose(0, 2, 1, 3).reshape(K * 7, K * 7)
        damp = lam * jnp.diag(jnp.diag(Hm)) + 1e-8 * jnp.eye(K * 7, dtype=dtype)
        dx = jnp.linalg.solve(Hm + damp, b.reshape(-1)).reshape(K, 7)
        dx = dx * fm[:, None]
        S_new = sim3_compose(sim3_exp(dx), S)
        return S_new, cost

    def cost_of(S):
        Si = jax.tree.map(lambda a: a[prob.e_i], S)
        Sj = jax.tree.map(lambda a: a[prob.e_j], S)
        r = jax.vmap(_edge_error)(Si, Sj, prob.e_Sji)
        return jnp.sum(jnp.sum(r * r, -1) * prob.e_valid.astype(dtype))

    def body(carry, _):
        S, lam, cost = carry
        S_new, _ = step(S, lam)
        cost_new = cost_of(S_new)
        accept = cost_new < cost
        S_next = jax.tree.map(
            lambda a, b_: jnp.where(accept, a, b_), S_new, S
        )
        lam_next = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e6)
        return (S_next, lam_next, jnp.where(accept, cost_new, cost)), cost

    (S_out, _, _), _ = jax.lax.scan(
        body,
        (prob.S, jnp.asarray(1e-4, dtype), cost_of(prob.S)),
        None,
        length=n_iters,
    )
    return S_out
