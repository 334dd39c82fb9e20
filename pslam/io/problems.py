"""Synthetic solver problems at a chosen shape, with exact ground truth.

One builder per solver: the frame pose solve (``pose_problem``), local BA
(``ba_problem``), the LIL composite-error BA edges (``lil_problem``) and the
Sim3 essential graph (``graph_problem``). The kernel and sharding checks
(``chip_smoke.py``, ``__graft_entry__.dryrun_multichip``,
``scripts/bench_kernels.py``) and the tests build their problems here, at
the tracking or global-BA widths or at a few edges, from a seed.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from pslam.geometry import Camera, project_stereo, se3_exp, transform_points


def _pad_rows(a, n, fill):
    a = np.asarray(a)
    out = np.full((n,) + a.shape[1:], fill, a.dtype)
    out[: len(a)] = a
    return out


def pose_problem(
    cam: Camera,
    E: int,
    seed: int,
    noise_px: float = 1.0,
    T_noise=(0.05, 0.2),
    invalid_frac: float = 0.1,
    outlier_frac: float = 0.0,
):
    """E point edges around a random pose T (rotation / translation std
    ``T_noise``): world points 1-8 m ahead, [u, v] with ``noise_px`` noise,
    ur with 1 px more, 30% mono edges (ur = -1), ``invalid_frac`` invalid
    edges and ``outlier_frac`` gross outliers (30 px on u). ``seed`` may
    also be a numpy Generator, which the caller then draws on from.
    Returns (PoseObs, T (4, 4) numpy)."""
    from pslam.solver.pose_opt import PoseObs

    rng = np.random.default_rng(seed)
    X = rng.uniform([-2, -2, 1], [2, 2, 8], (E, 3)).astype(np.float32)
    T = np.asarray(se3_exp(jnp.asarray(np.r_[
        rng.normal(0, T_noise[0], 3), rng.normal(0, T_noise[1], 3)
    ].astype(np.float32))))
    Xc = X @ T[:3, :3].T + T[:3, 3]
    u = cam.fx * Xc[:, 0] / Xc[:, 2] + cam.cx + rng.normal(0, noise_px, E)
    v = cam.fy * Xc[:, 1] / Xc[:, 2] + cam.cy + rng.normal(0, noise_px, E)
    ur = u - cam.bf / Xc[:, 2] + rng.normal(0, 1, E)
    ur[rng.uniform(size=E) < 0.3] = -1.0
    inv_s2 = rng.uniform(0.3, 1.0, E).astype(np.float32)
    valid = rng.uniform(size=E) > invalid_frac
    if outlier_frac > 0:
        out = rng.uniform(size=E) < outlier_frac
        u[out] += rng.normal(0, 30, out.sum())
    po = PoseObs(
        X_w=jnp.asarray(X),
        obs=jnp.asarray(np.stack([u, v, ur], 1).astype(np.float32)),
        inv_sigma2=jnp.asarray(inv_s2),
        valid=jnp.asarray(valid),
    )
    return po, T


def ba_problem(cam: Camera, C: int, P: int, E: int, n_free: int, seed: int):
    """A local-BA problem: C cameras 5 cm apart along x (camera 0 and those
    past ``n_free`` fixed), P points with 2 cm of noise on their initial
    position, E stereo observations with 0.3 px noise."""
    from pslam.solver.local_ba import BAProblem

    rng = np.random.default_rng(seed)
    X = rng.uniform([-3, -2, 1], [3, 2, 8], (P, 3)).astype(np.float32)
    xi = np.c_[rng.normal(0, 0.01, (C, 3)), 0.05 * np.arange(C),
               np.zeros(C), np.zeros(C)].astype(np.float32)
    T_cw = np.stack([np.asarray(se3_exp(jnp.asarray(x))) for x in xi])
    cam_idx = rng.integers(0, C, E).astype(np.int32)
    pt_idx = rng.integers(0, P, E).astype(np.int32)
    Xc = transform_points(jnp.asarray(T_cw)[cam_idx], jnp.asarray(X)[pt_idx])
    obs = np.asarray(project_stereo(cam, Xc)) + rng.normal(0, 0.3, (E, 3))
    free_slot = np.full(C, -1, np.int32)
    free_slot[1 : 1 + n_free] = np.arange(n_free)
    return BAProblem(
        T_cw=jnp.asarray(T_cw),
        free_slot=jnp.asarray(free_slot),
        X_w=jnp.asarray(X + rng.normal(0, 0.02, X.shape).astype(np.float32)),
        point_valid=jnp.ones(P, bool),
        cam_idx=jnp.asarray(cam_idx),
        pt_idx=jnp.asarray(pt_idx),
        obs=jnp.asarray(obs.astype(np.float32)),
        inv_sigma2=jnp.ones(E, jnp.float32),
        edge_valid=jnp.ones(E, bool),
    )


def lil_problem(cam: Camera, T_cw, Q: int, El: int, seed: int):
    """Q LIL landmarks (two 0.6 m segments crossing at a point) seen El
    times by the cameras of T_cw: observations are the projected lines and
    intersection with 0.5 px noise; the initial states are shifted by
    ~5 cm. Returns (state (Q, 15), LILBAEdges)."""
    from pslam.solver.ba_lil import LILBAEdges

    rng = np.random.default_rng(seed)
    X = rng.uniform([-2, -1, 2], [2, 1, 6], (Q, 3))
    d1 = rng.normal(size=(Q, 3))
    d2 = np.cross(d1, rng.normal(size=(Q, 3)))
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    pts = np.stack([X - 0.3 * d1, X + 0.3 * d1, X - 0.3 * d2, X + 0.3 * d2, X],
                   axis=1)  # (Q, 5, 3): [P1s, P1e, P2s, P2e, X_ins]
    cam_idx = rng.integers(0, len(T_cw), El)
    lil_idx = rng.integers(0, Q, El)
    T = np.asarray(T_cw, np.float64)[cam_idx]
    Xc = np.einsum("eij,ekj->eki", T[:, :3, :3], pts[lil_idx]) + T[:, None, :3, 3]
    uv = np.stack([cam.fx * Xc[..., 0] / Xc[..., 2] + cam.cx,
                   cam.fy * Xc[..., 1] / Xc[..., 2] + cam.cy], axis=-1)
    uv += rng.normal(0, 0.5, uv.shape)
    h = np.concatenate([uv, np.ones(uv.shape[:-1] + (1,))], axis=-1)

    def line(a, b):
        eq = np.cross(a, b)
        return eq / np.linalg.norm(eq[:, :2], axis=1, keepdims=True)

    obs = np.concatenate([line(h[:, 0], h[:, 1]), line(h[:, 2], h[:, 3]),
                          uv[:, 4]], axis=1)
    state = pts + rng.normal(0, 0.05, (Q, 1, 3))
    edges = LILBAEdges(
        cam_idx=jnp.asarray(cam_idx.astype(np.int32)),
        lil_idx=jnp.asarray(lil_idx.astype(np.int32)),
        obs=jnp.asarray(obs.astype(np.float32)),
        valid=jnp.ones(El, bool),
    )
    return jnp.asarray(state.reshape(Q, 15).astype(np.float32)), edges


def graph_problem(K: int, seed: int, edge_multiple: int = 1):
    """A Sim3 pose graph over K keyframes on a 3 m circle, every pair
    joined by its exact relative measurement, vertices (all but the fixed
    first) perturbed by 1 cm / 3 cm of rotation / translation noise. The
    edge list is padded with invalid edges to a multiple of
    ``edge_multiple`` (a mesh's size)."""
    from pslam.geometry.lie import Sim3, sim3_compose, sim3_exp, sim3_inverse
    from pslam.solver.sim3_graph import PoseGraphProblem

    rng = np.random.default_rng(seed)
    gt = []
    for k in range(K):
        a = 2 * np.pi * k / K
        T = np.asarray(se3_exp(jnp.asarray(
            np.r_[0, a, 0, 3 * np.cos(a), 0, 3 * np.sin(a)].astype(np.float32))))
        gt.append(Sim3(s=jnp.float32(1.0), R=jnp.asarray(T[:3, :3]),
                       t=jnp.asarray(T[:3, 3])))
    est = []
    for k in range(K):
        noise = sim3_exp(jnp.asarray(np.r_[rng.normal(0, 0.01, 3),
                                           rng.normal(0, 0.03, 3), 0.0]
                                     .astype(np.float32)))
        est.append(gt[k] if k == 0 else sim3_compose(noise, gt[k]))
    ii, jj = np.triu_indices(K, 1)
    meas = [sim3_compose(gt[j], sim3_inverse(gt[i])) for i, j in zip(ii, jj)]
    n_e = -(-len(ii) // edge_multiple) * edge_multiple
    R = np.tile(np.eye(3, dtype=np.float32), (n_e, 1, 1))  # padding: identity
    R[: len(ii)] = np.stack([np.asarray(m.R) for m in meas])
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return PoseGraphProblem(
        S=Sim3(s=jnp.stack([x.s for x in est]),
               R=jnp.stack([x.R for x in est]),
               t=jnp.stack([x.t for x in est])),
        fixed=jnp.asarray(fixed),
        vertex_valid=jnp.ones(K, bool),
        e_i=jnp.asarray(_pad_rows(ii.astype(np.int32), n_e, 0)),
        e_j=jnp.asarray(_pad_rows(jj.astype(np.int32), n_e, 0)),
        e_Sji=Sim3(
            s=jnp.asarray(_pad_rows([np.asarray(m.s) for m in meas], n_e, 1.0)),
            R=jnp.asarray(R),
            t=jnp.asarray(_pad_rows([np.asarray(m.t) for m in meas], n_e, 0.0)),
        ),
        e_valid=jnp.asarray(_pad_rows(np.ones(len(ii), bool), n_e, False)),
    )
