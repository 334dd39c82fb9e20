"""Edge-sharded Sim3 essential-graph optimization.

Distributes OptimizeEssentialGraph (reference src/Optimizer.cc:2536-2799;
single-threaded g2o there) over a device mesh: pose-graph EDGES are the data
axis — each device computes Sim3 residuals + 7x7 Jacobian blocks for its
edge shard and scatter-adds them into the (K, K, 7, 7) block lattice; one
``psum`` across devices yields the full normal equations on every device,
and the dense damped-GN solve runs replicated (K <= a few hundred
keyframes, so the solve is small; replicating beats a broadcast
round-trip).

Numerics are identical to solver.sim3_graph.optimize_essential_graph up to
float summation order — equivalence-tested on the 8-device CPU mesh.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from pslam.geometry.lie import Sim3, sim3_compose, sim3_exp
from pslam.solver.sim3_graph import (
    PoseGraphProblem,
    _edge_error,
    _edge_error_delta,
)


def optimize_essential_graph_sharded(
    prob: PoseGraphProblem, mesh: Mesh, n_iters: int = 20, axis: str = "edges"
) -> Sim3:
    """Distributed drop-in for optimize_essential_graph. Edge-array lengths
    must be divisible by the mesh size."""
    K = prob.fixed.shape[0]
    dtype = prob.S.t.dtype
    free = prob.vertex_valid & ~prob.fixed

    jac_fn = jax.vmap(
        jax.jacfwd(_edge_error_delta, argnums=(0, 1)),
        in_axes=(None, None, 0, 0, 0),
    )

    espec = (P(axis), P(axis), Sim3(s=P(axis), R=P(axis), t=P(axis)), P(axis))

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(Sim3(s=P(), R=P(), t=P()), espec),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    def assemble_shard(S, edges):
        e_i, e_j, e_Sji, e_valid = edges
        Si = jax.tree.map(lambda a: a[e_i], S)
        Sj = jax.tree.map(lambda a: a[e_j], S)
        r = jax.vmap(_edge_error)(Si, Sj, e_Sji)  # (Es, 7)
        Ji, Jj = jac_fn(
            jnp.zeros(7, dtype), jnp.zeros(7, dtype), Si, Sj, e_Sji
        )
        w = e_valid.astype(dtype)
        cost = jnp.sum(jnp.sum(r * r, -1) * w)

        Hii = jnp.einsum("eri,erj,e->eij", Ji, Ji, w)
        Hjj = jnp.einsum("eri,erj,e->eij", Jj, Jj, w)
        Hij = jnp.einsum("eri,erj,e->eij", Ji, Jj, w)
        bi = -jnp.einsum("eri,er,e->ei", Ji, r, w)
        bj = -jnp.einsum("eri,er,e->ei", Jj, r, w)

        H = jnp.zeros((K, K, 7, 7), dtype)
        H = H.at[e_i, e_i].add(Hii)
        H = H.at[e_j, e_j].add(Hjj)
        H = H.at[e_i, e_j].add(Hij)
        H = H.at[e_j, e_i].add(jnp.swapaxes(Hij, -1, -2))
        b = jnp.zeros((K, 7), dtype)
        b = b.at[e_i].add(bi)
        b = b.at[e_j].add(bj)
        H, b, cost = jax.lax.psum((H, b, cost), axis)
        return H, b, cost

    edges = (prob.e_i, prob.e_j, prob.e_Sji, prob.e_valid)

    @jax.jit
    def run(S0):
        # One assembly per iteration: the normal equations at the current
        # estimate ride the carry; each step solves from them, assembles
        # once at the proposal, and keeps the proposal's blocks on accept.
        def solve(H, b, lam):
            fm = free.astype(dtype)
            H = H * fm[:, None, None, None] * fm[None, :, None, None]
            eye7 = jnp.eye(7, dtype=dtype)
            diag_fix = (1.0 - fm)[:, None, None] * eye7[None]
            H = H.at[jnp.arange(K), jnp.arange(K)].add(diag_fix)
            b = b * fm[:, None]
            Hm = H.transpose(0, 2, 1, 3).reshape(K * 7, K * 7)
            damp = lam * jnp.diag(jnp.diag(Hm)) + 1e-8 * jnp.eye(
                K * 7, dtype=dtype
            )
            dx = jnp.linalg.solve(Hm + damp, b.reshape(-1)).reshape(K, 7)
            return dx * fm[:, None]

        def body(carry, _):
            S, lam, cost, H, b = carry
            dx = solve(H, b, lam)
            S_new = sim3_compose(sim3_exp(dx), S)
            H_new, b_new, cost_new = assemble_shard(S_new, edges)
            accept = cost_new < cost
            sel = lambda a, b_: jnp.where(accept, a, b_)  # noqa: E731
            S_next = jax.tree.map(sel, S_new, S)
            lam_next = jnp.clip(
                jnp.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e6
            )
            return (
                S_next, lam_next, jnp.where(accept, cost_new, cost),
                sel(H_new, H), sel(b_new, b),
            ), None

        H0, b0, cost0 = assemble_shard(S0, edges)
        (S_out, *_), _ = jax.lax.scan(
            body,
            (S0, jnp.asarray(1e-4, dtype), cost0, H0, b0),
            None,
            length=n_iters,
        )
        return S_out

    return run(prob.S)
