"""Profile the keyframe-rate backend on the default device: local-BA internals
(edge terms / assembly / Schur solve) and epipolar triangulation."""

import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


R = 10


def timeit(name, fn, *args):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def loop(*args):
        def body(c, _):
            def perturb(x):
                if jnp.issubdtype(x.dtype, jnp.floating):
                    return x + (c * 1e-30).astype(x.dtype)
                return x

            args_c = jax.tree_util.tree_map(perturb, args)
            out = fn(*args_c)
            leaves = jax.tree_util.tree_leaves(out)
            s = sum(jnp.sum(x.astype(jnp.float32)) for x in leaves if x.size)
            return c + s * 1e-20, None

        c, _ = jax.lax.scan(body, jnp.float32(0.0), None, length=R)
        return c

    jax.block_until_ready(loop(*args))
    t0 = time.time()
    jax.block_until_ready(loop(*args))
    dt = (time.time() - t0) / R * 1e3
    log(f"{name:38s} {dt:8.3f} ms")
    return dt


def main():
    import jax
    import jax.numpy as jnp

    from pslam.geometry import project_stereo, se3_exp, transform_points
    from pslam.solver.local_ba import (
        BAProblem,
        _assemble,
        _edge_terms,
        _solve_schur,
        local_bundle_adjustment,
    )
    from pslam.utils.config import SlamConfig

    cfg = SlamConfig()
    cam = cfg.camera
    caps = cfg.caps
    log("device:", jax.devices()[0])

    rng = np.random.default_rng(0)
    C, P, E, n_free = caps.ba_cams, caps.ba_points, caps.ba_edges, caps.ba_free
    X = rng.uniform([-3, -2, 1], [3, 2, 8], (P, 3)).astype(np.float32)
    T_cw = np.stack(
        [
            np.asarray(
                se3_exp(jnp.asarray(np.r_[rng.normal(0, 0.01, 3), 0.05 * c, 0, 0]
                                    .astype(np.float32)))
            )
            for c in range(C)
        ]
    )
    cam_idx = rng.integers(0, C, E).astype(np.int32)
    pt_idx = rng.integers(0, P, E).astype(np.int32)
    Xc = transform_points(jnp.asarray(T_cw)[cam_idx], jnp.asarray(X)[pt_idx])
    obs = np.asarray(project_stereo(cam, Xc)) + rng.normal(0, 0.3, (E, 3)).astype(np.float32)
    free_slot = np.full(C, -1, np.int32)
    free_slot[1 : 1 + n_free] = np.arange(n_free)
    prob = BAProblem(
        T_cw=jnp.asarray(T_cw.astype(np.float32)),
        free_slot=jnp.asarray(free_slot),
        X_w=jnp.asarray(X + rng.normal(0, 0.02, X.shape).astype(np.float32)),
        point_valid=jnp.ones(P, bool),
        cam_idx=jnp.asarray(cam_idx),
        pt_idx=jnp.asarray(pt_idx),
        obs=jnp.asarray(obs.astype(np.float32)),
        inv_sigma2=jnp.ones(E, jnp.float32),
        edge_valid=jnp.ones(E, bool),
    )

    def terms(T_all, X_all):
        return _edge_terms(cam, prob, T_all, X_all, prob.edge_valid, True)

    T_all = prob.T_cw
    X_all = prob.X_w
    timeit("edge_terms (16384 e)", terms, T_all, X_all)

    chi2, w_eff, r, Jc, Jp, cost = jax.jit(terms)(T_all, X_all)
    r, Jc, Jp, w_eff = map(jax.block_until_ready, (r, Jc, Jp, w_eff))

    def assemble(w_eff, r, Jc, Jp):
        return _assemble(prob, n_free, w_eff, r, Jc, Jp)

    timeit("assemble (scatter-adds)", assemble, w_eff, r, Jc, Jp)
    Hcc, bc, Hpp, bp, G = jax.jit(assemble)(w_eff, r, Jc, Jp)
    Hcc, bc, Hpp, bp, G = map(jax.block_until_ready, (Hcc, bc, Hpp, bp, G))

    def schur(Hcc, bc, Hpp, bp, G):
        return _solve_schur(Hcc, bc, Hpp, bp, G, prob.point_valid,
                            jnp.float32(1e-4))

    timeit("solve_schur", schur, Hcc, bc, Hpp, bp, G)

    def full_ba(p):
        return local_bundle_adjustment(cam, p, n_free)

    t0 = time.time()
    np.asarray(full_ba(prob)[0])
    log(f"full BA compile+first: {time.time()-t0:.1f}s")
    t0 = time.time()
    for _ in range(3):
        np.asarray(full_ba(prob)[0])
    log(f"full BA (5+10 LM): {(time.time()-t0)/3*1e3:.2f} ms")

    # --- triangulation ----------------------------------------------------
    from pslam.ops.triangulate import KFView, epipolar_triangulate

    N = cfg.orb.capacity

    def mk_view(c):
        return KFView(
            T_cw=jnp.asarray(T_cw[c].astype(np.float32)),
            uv=jnp.asarray(obs[rng.integers(0, E, N), :2].astype(np.float32)),
            ur=jnp.asarray(np.full(N, -1, np.float32)),
            depth=jnp.asarray(rng.uniform(1, 5, N).astype(np.float32)),
            level=jnp.zeros(N, jnp.int32),
            angle=jnp.zeros(N, jnp.float32),
            desc=jnp.asarray(rng.integers(0, 256, (N, 32), dtype=np.uint8)),
            free=jnp.ones(N, bool),
        )

    v1, v2 = mk_view(0), mk_view(1)
    timeit(
        "epipolar_triangulate",
        lambda a, b: epipolar_triangulate(cam, a, b, 1.2, 8),
        v1, v2,
    )

    # Row-gather suspicion: time a bare 1000-row gather by index.
    j = jnp.asarray(rng.integers(0, N, N).astype(np.int32))
    vals = jnp.asarray(rng.normal(size=(N, 3)).astype(np.float32))
    timeit("bare gather (1000 rows of 3)", lambda v, jj: v[jj], vals, j)

    from pslam.ops.match import hamming_matrix, mutual_nn_match

    timeit(
        "hamming+mutualNN (1000x1000)",
        lambda a, b: mutual_nn_match(
            hamming_matrix(a.desc, b.desc), valid_a=a.free, valid_b=b.free,
            max_dist=50, ratio=1.0,
        ),
        v1, v2,
    )


if __name__ == "__main__":
    main()
