"""Time the sharded solvers on the device with a 1-device mesh.

VERDICT r4 item 6: the edge-sharded solvers were only ever equivalence-
tested on the virtual 8-device CPU mesh; this flushes device-specific
lowering issues (psum_scatter layouts) and measures the sharding
machinery's single-device overhead vs the plain path. Done-gate:
overhead < 10% or explained.

Shapes mirror bench.py's ladder-calibrated typical local BA
(48 cams / 2048 pts / 8192 edges) + 512 LIL edges + a 128-KF / 256-edge
Sim3 essential graph. Prints one JSON line of results.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _scan_time(fn, *args, R=6):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def loop(*args):
        def body(c, _):
            args_c = jax.tree_util.tree_map(
                lambda x: x + (c * 1e-30).astype(x.dtype)
                if jnp.issubdtype(x.dtype, jnp.floating) else x, args)
            out = fn(*args_c)
            s = sum(jnp.sum(x.astype(jnp.float32))
                    for x in jax.tree_util.tree_leaves(out))
            return c + s * 1e-20, None
        c, _ = jax.lax.scan(body, jnp.float32(0.0), None, length=R)
        return c

    jax.block_until_ready(loop(*args))
    t0 = time.time()
    jax.block_until_ready(loop(*args))
    return (time.time() - t0) / R


def main():
    import jax
    import jax.numpy as jnp

    from pslam.utils.backend import enable_compile_cache

    enable_compile_cache()

    from pslam.geometry import project_stereo, se3_exp, transform_points
    from pslam.parallel import make_ba_mesh, sharded_local_bundle_adjustment
    from pslam.parallel.sharded_ba import sharded_local_bundle_adjustment_lil
    from pslam.parallel.sharded_graph import optimize_essential_graph_sharded
    from pslam.solver import local_bundle_adjustment
    from pslam.solver.ba_lil import LILBAEdges, local_bundle_adjustment_lil
    from pslam.solver.sim3_graph import optimize_essential_graph
    from pslam.utils.config import SlamConfig

    cfg = SlamConfig()
    cam, caps = cfg.camera, cfg.caps
    dev = jax.devices()
    log("devices:", dev)
    mesh = make_ba_mesh()
    results = {"device": str(dev[0]), "mesh_size": len(dev)}

    # ---- local BA problem (bench.py's typical shape) ---------------------
    from pslam.solver.local_ba import BAProblem

    rng = np.random.default_rng(0)
    C, Pn, E, n_free = caps.ba_cams, 2048, 8192, caps.ba_free
    X = rng.uniform([-3, -2, 1], [3, 2, 8], (Pn, 3)).astype(np.float32)
    T_cw = np.stack([
        np.asarray(se3_exp(jnp.asarray(
            np.r_[rng.normal(0, 0.01, 3), 0.05 * c, 0, 0].astype(np.float32))))
        for c in range(C)
    ])
    cam_idx = rng.integers(0, C, E).astype(np.int32)
    pt_idx = rng.integers(0, Pn, E).astype(np.int32)
    Xc = transform_points(jnp.asarray(T_cw)[cam_idx], jnp.asarray(X)[pt_idx])
    obs = np.asarray(project_stereo(cam, Xc)) + rng.normal(0, 0.3, (E, 3)).astype(np.float32)
    free_slot = np.full(C, -1, np.int32)
    free_slot[1: 1 + n_free] = np.arange(n_free)
    prob = BAProblem(
        T_cw=jnp.asarray(T_cw.astype(np.float32)),
        free_slot=jnp.asarray(free_slot),
        X_w=jnp.asarray(X + rng.normal(0, 0.02, X.shape).astype(np.float32)),
        point_valid=jnp.ones(Pn, bool),
        cam_idx=jnp.asarray(cam_idx), pt_idx=jnp.asarray(pt_idx),
        obs=jnp.asarray(obs.astype(np.float32)),
        inv_sigma2=jnp.ones(E, jnp.float32),
        edge_valid=jnp.ones(E, bool),
    )

    t_plain = _scan_time(lambda p: local_bundle_adjustment(cam, p, n_free), prob)
    t_shard = _scan_time(
        lambda p: sharded_local_bundle_adjustment(cam, p, n_free, mesh), prob)
    # Correctness on device: same pose solution as the plain path.
    T_s, X_s, *_ = sharded_local_bundle_adjustment(cam, prob, n_free, mesh)
    T_1, X_1, *_ = local_bundle_adjustment(cam, prob, n_free)
    dT = float(np.abs(np.asarray(T_s) - np.asarray(T_1)).max())
    log(f"local BA: plain {t_plain*1e3:.2f} ms, sharded(mesh={len(dev)}) "
        f"{t_shard*1e3:.2f} ms, overhead {100*(t_shard/t_plain-1):+.1f}%, "
        f"max|dT| {dT:.2e}")
    results["local_ba"] = dict(
        plain_ms=round(t_plain * 1e3, 3), sharded_ms=round(t_shard * 1e3, 3),
        overhead_pct=round(100 * (t_shard / t_plain - 1), 1),
        max_abs_dT=float(dT),
    )

    # ---- LIL composite BA ------------------------------------------------
    Q, El = 64, caps.ba_lil_edges
    lil_state = jnp.asarray(
        np.concatenate([
            rng.uniform([-3, -2, 1], [3, 2, 8], (Q, 3)).astype(np.float32)
        ] * 5, axis=1))
    lil_valid = jnp.ones(Q, bool)
    ledges = LILBAEdges(
        cam_idx=jnp.asarray(rng.integers(0, C, El).astype(np.int32)),
        lil_idx=jnp.asarray(rng.integers(0, Q, El).astype(np.int32)),
        obs=jnp.asarray(rng.normal(0, 1, (El, 8)).astype(np.float32)),
        valid=jnp.ones(El, bool),
    )
    t_plain_l = _scan_time(
        lambda p, s, v, e: local_bundle_adjustment_lil(cam, p, s, v, e, n_free),
        prob, lil_state, lil_valid, ledges)
    t_shard_l = _scan_time(
        lambda p, s, v, e: sharded_local_bundle_adjustment_lil(
            cam, p, s, v, e, n_free, mesh),
        prob, lil_state, lil_valid, ledges)
    log(f"LIL BA: plain {t_plain_l*1e3:.2f} ms, sharded {t_shard_l*1e3:.2f} ms, "
        f"overhead {100*(t_shard_l/t_plain_l-1):+.1f}%")
    results["lil_ba"] = dict(
        plain_ms=round(t_plain_l * 1e3, 3),
        sharded_ms=round(t_shard_l * 1e3, 3),
        overhead_pct=round(100 * (t_shard_l / t_plain_l - 1), 1),
    )

    # ---- essential graph -------------------------------------------------
    from pslam.geometry.lie import Sim3
    from pslam.solver.sim3_graph import PoseGraphProblem

    K, Eg = 128, 256
    angles = 2 * np.pi * np.arange(K) / K
    Rk = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    tk = np.stack([np.cos(angles), np.zeros(K), np.sin(angles)], -1).astype(np.float32)
    tk += rng.normal(0, 0.02, tk.shape).astype(np.float32)
    e_i = np.r_[np.arange(K - 1), rng.integers(0, K, Eg - (K - 1))].astype(np.int32)
    e_j = np.r_[np.arange(1, K), rng.integers(0, K, Eg - (K - 1))].astype(np.int32)
    e_j = np.where(e_j == e_i, (e_j + 1) % K, e_j).astype(np.int32)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    gprob = PoseGraphProblem(
        S=Sim3(s=jnp.ones(K, jnp.float32), R=jnp.asarray(Rk), t=jnp.asarray(tk)),
        fixed=jnp.asarray(fixed), vertex_valid=jnp.ones(K, bool),
        e_i=jnp.asarray(e_i), e_j=jnp.asarray(e_j),
        e_Sji=Sim3(s=jnp.ones(Eg, jnp.float32),
                   R=jnp.tile(jnp.eye(3, dtype=jnp.float32), (Eg, 1, 1)),
                   t=jnp.zeros((Eg, 3), jnp.float32)),
        e_valid=jnp.ones(Eg, bool),
    )
    t_plain_g = _scan_time(lambda p: optimize_essential_graph(p, n_iters=20), gprob, R=3)
    t_shard_g = _scan_time(
        lambda p: optimize_essential_graph_sharded(p, mesh, n_iters=20), gprob, R=3)
    log(f"essential graph: plain {t_plain_g*1e3:.2f} ms, sharded "
        f"{t_shard_g*1e3:.2f} ms, overhead {100*(t_shard_g/t_plain_g-1):+.1f}%")
    results["essential_graph"] = dict(
        plain_ms=round(t_plain_g * 1e3, 3),
        sharded_ms=round(t_shard_g * 1e3, 3),
        overhead_pct=round(100 * (t_shard_g / t_plain_g - 1), 1),
    )

    print(json.dumps(results))


if __name__ == "__main__":
    main()
