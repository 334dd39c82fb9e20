"""Distributed-BA scaling measurement on the virtual CPU mesh.

Times one edge-sharded local-BA solve (parallel/sharded_ba.py) and one
edge-sharded essential-graph solve (parallel/sharded_graph.py) at 1/2/4/8
virtual devices and writes SCALING.md.

Caveat stated in the output: this host exposes 2 physical cores, so >2
virtual devices share cores and wall-clock speedup saturates; the
measurement that matters is 1 -> 2 devices (real parallel hardware) plus
the per-device work/communication accounting, which is device-count exact.
Run with:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 python scripts/bench_scaling.py
"""

import os
import sys
import time

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from pslam.geometry import Camera, project_stereo, se3_exp, transform_points
    from pslam.parallel.sharded_ba import (
        make_ba_mesh,
        sharded_local_bundle_adjustment,
    )

    n_phys = os.cpu_count()
    devs = jax.devices()
    print(f"{len(devs)} virtual devices on {n_phys} physical cores")

    # A BA problem big enough that per-edge work dominates: 64 cams,
    # 8192 points, 65536 edges (a global-BA-sized solve).
    cam = Camera(fx=517.3, fy=516.5, cx=318.6, cy=255.3, bf=40.0)
    rng = np.random.default_rng(0)
    C, P, E, n_free = 64, 8192, 65536, 32
    from pslam.solver.local_ba import BAProblem

    X = rng.uniform([-3, -2, 1], [3, 2, 8], (P, 3)).astype(np.float32)
    T_cw = np.stack(
        [
            np.asarray(
                se3_exp(
                    jnp.asarray(
                        np.r_[rng.normal(0, 0.01, 3), 0.05 * c, 0, 0].astype(
                            np.float32
                        )
                    )
                )
            )
            for c in range(C)
        ]
    )
    cam_idx = rng.integers(0, C, E).astype(np.int32)
    pt_idx = rng.integers(0, P, E).astype(np.int32)
    Xc = transform_points(jnp.asarray(T_cw)[cam_idx], jnp.asarray(X)[pt_idx])
    obs = np.asarray(project_stereo(cam, Xc)) + rng.normal(0, 0.3, (E, 3)).astype(
        np.float32
    )
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

    rows = []
    for nd in (1, 2, 4, 8):
        if nd > len(devs):
            continue
        mesh = make_ba_mesh(devs[:nd])
        f = jax.jit(
            lambda p, mesh=mesh: sharded_local_bundle_adjustment(
                cam, p, n_free, mesh, schedule=(3, 3)
            )
        )
        jax.block_until_ready(f(prob))  # compile
        reps = 3
        t0 = time.time()
        for _ in range(reps):
            jax.block_until_ready(f(prob))
        dt = (time.time() - t0) / reps
        rows.append((nd, dt))
        print(f"BA {nd} dev: {dt*1e3:8.1f} ms  (edges/dev {E//nd})")

    # Essential graph: K=192 vertices, ~1.5K edges.
    from pslam.geometry.lie import Sim3, sim3_compose, sim3_exp as s3exp, sim3_inverse
    from pslam.parallel.sharded_graph import optimize_essential_graph_sharded
    from pslam.solver.sim3_graph import PoseGraphProblem

    K = 192
    gt = []
    for k in range(K):
        a = 2 * np.pi * k / K
        xi = np.r_[0, a, 0, 3 * np.cos(a), 0, 3 * np.sin(a)].astype(np.float32)
        T = np.asarray(se3_exp(jnp.asarray(xi)))
        gt.append(
            Sim3(s=jnp.float32(1.0), R=jnp.asarray(T[:3, :3]), t=jnp.asarray(T[:3, 3]))
        )
    meas, e_i, e_j = [], [], []
    for i in range(K):
        for d in (1, 2, 5):
            j = (i + d) % K
            meas.append(sim3_compose(gt[j], sim3_inverse(gt[i])))
            e_i.append(i)
            e_j.append(j)
    E2 = -(-len(meas) // 8) * 8
    ms = np.ones(E2, np.float32)
    mR = np.tile(np.eye(3, dtype=np.float32), (E2, 1, 1))
    mt = np.zeros((E2, 3), np.float32)
    n_e = len(meas)
    ms[:n_e] = np.stack([np.asarray(m.s) for m in meas])
    mR[:n_e] = np.stack([np.asarray(m.R) for m in meas])
    mt[:n_e] = np.stack([np.asarray(m.t) for m in meas])
    ok = np.zeros(E2, bool)
    ok[:n_e] = True
    ei = np.zeros(E2, np.int32)
    ej = np.zeros(E2, np.int32)
    ei[:n_e] = e_i
    ej[:n_e] = e_j
    est = [
        sim3_compose(
            s3exp(jnp.asarray(np.r_[rng.normal(0, 0.005, 6), 0].astype(np.float32))),
            g,
        )
        for g in gt
    ]
    fixed = np.zeros(K, bool)
    fixed[0] = True
    prob2 = PoseGraphProblem(
        S=Sim3(
            s=jnp.stack([e.s for e in est]),
            R=jnp.stack([e.R for e in est]),
            t=jnp.stack([e.t for e in est]),
        ),
        fixed=jnp.asarray(fixed),
        vertex_valid=jnp.ones(K, bool),
        e_i=jnp.asarray(ei),
        e_j=jnp.asarray(ej),
        e_Sji=Sim3(s=jnp.asarray(ms), R=jnp.asarray(mR), t=jnp.asarray(mt)),
        e_valid=jnp.asarray(ok),
    )
    rows_g = []
    for nd in (1, 2, 4, 8):
        if nd > len(devs):
            continue
        mesh = make_ba_mesh(devs[:nd])
        t0 = time.time()
        jax.block_until_ready(
            optimize_essential_graph_sharded(prob2, mesh, n_iters=5)
        )
        compile_and_first = time.time() - t0
        t0 = time.time()
        jax.block_until_ready(
            optimize_essential_graph_sharded(prob2, mesh, n_iters=5)
        )
        dt = time.time() - t0
        rows_g.append((nd, dt))
        print(f"EG {nd} dev: {dt*1e3:8.1f} ms (first {compile_and_first:.1f}s)")

    out = os.path.join(os.path.dirname(__file__), "..", "SCALING.md")
    with open(out, "w") as f:
        f.write(
            "# Distributed-solver scaling (virtual CPU mesh)\n\n"
            f"Host: {n_phys} physical cores, {len(devs)} XLA virtual devices\n"
            "(`--xla_force_host_platform_device_count`). **Wall-clock speedup\n"
            f"is only meaningful up to {n_phys} devices here** — beyond that the\n"
            "virtual devices time-share cores; per-device work (edges/device)\n"
            "still halves per doubling exactly, and the collective structure\n"
            "(one psum of the reduced camera system per iteration) is what\n"
            "rides the interconnect of real multi-device hardware.\n\n"
            f"## Edge-sharded BA ({C} cams / {P} pts / {E} edges, 6 LM iters)\n\n"
            "| devices | ms/solve | speedup | efficiency | edges/device |\n"
            "|---|---|---|---|---|\n"
        )
        t1 = rows[0][1]
        for nd, dt in rows:
            f.write(
                f"| {nd} | {dt*1e3:.1f} | {t1/dt:.2f}x | {t1/dt/nd:.2f} | {E//nd} |\n"
            )
        f.write(
            f"\n## Edge-sharded Sim3 essential graph (K={K}, {n_e} edges, 5 GN iters)\n\n"
            "| devices | ms/solve | speedup |\n|---|---|---|\n"
        )
        tg1 = rows_g[0][1]
        for nd, dt in rows_g:
            f.write(f"| {nd} | {dt*1e3:.1f} | {tg1/dt:.2f}x |\n")
        f.write(f"\nGenerated by scripts/bench_scaling.py, {time.strftime('%Y-%m-%d')}.\n")
    print("wrote", os.path.abspath(out))


if __name__ == "__main__":
    main()
