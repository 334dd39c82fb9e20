"""Benchmark: full-system RGB-D SLAM throughput on one device.

Measures two numbers:

1. DEPLOYED: drives the real `SlamSystem` end-to-end (depth-1 pipelined
   tracking API) over a rendered sequence — host orchestration, keyframe
   backend, async local BA, loop closing, everything.
2. DEVICE-BOUND: scans the SAME per-frame device program the deployed system
   dispatches (`frame_step`, one dispatch/frame) plus the keyframe-rate
   backend programs (local BA at the ladder-calibrated typical shape,
   batched epipolar triangulation), amortized at the KF rate observed in
   the deployed run. The backend solve is dispatched asynchronously in
   deployment, so tracking + amortized backend is the per-device budget.

Every timing ends in ``jax.block_until_ready``.

Baseline: MEASURED on this host (BASELINE_MEASURED.json, produced by
scripts/measure_baseline.py): the reference's per-frame hot path (cv::ORB
1000 features/8 levels + LSD line detection + LBD + Hamming matching,
g++ -O3 -march=native) timed on the same synthetic sequence. The full
reference cannot build here (no Eigen3/Pangolin/PCL), and the measured path
EXCLUDES its per-line 3D RANSAC, fan detection and 2x g2o pose optimization
per frame — so the denominator is an upper bound on the reference's fps and
vs_baseline is conservative. North-star target: vs_baseline >= 5.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
"""

import json
import os
import sys
import time

import numpy as np

N_DEPLOYED = 120
N_SCAN = 16
_REPO = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def baseline_fps() -> tuple[float, str]:
    """Measured C++ hot-path fps (falls back to the r<=4 assumed 20)."""
    path = os.path.join(_REPO, "BASELINE_MEASURED.json")
    if not os.path.exists(path):
        # Measure on the spot (~2 min). The script imports pslam for its
        # synthetic sequence; JAX_PLATFORMS=cpu keeps it off the device,
        # which this process holds.
        import subprocess

        subprocess.run(
            [sys.executable, os.path.join(_REPO, "scripts", "measure_baseline.py")],
            timeout=1500, check=True, capture_output=True,
            env={**os.environ, "JAX_PLATFORMS": "cpu"},
        )
    if os.path.exists(path):
        with open(path) as f:
            d = json.load(f)
        return float(d["fps"]), "measured"
    return 20.0, "assumed"


def main():
    import jax
    import jax.numpy as jnp

    from pslam.utils.backend import enable_compile_cache

    enable_compile_cache()

    from pslam.io.synthetic import render_sequence
    from pslam.pipeline import frame_step as fstep
    from pslam.pipeline.system import SlamSystem
    from pslam.utils.config import SlamConfig
    from pslam.utils.metrics import ate_rmse, trajectory_positions

    cfg = SlamConfig()
    log("device:", jax.devices()[0])

    log(f"rendering {N_DEPLOYED} frames...")
    grays, depths, poses_gt = render_sequence(
        cfg.camera, n_frames=N_DEPLOYED, seed=0
    )

    # ---- 1. deployed system, pipelined tracking API ----------------------
    s = SlamSystem(cfg)
    times = np.zeros(N_DEPLOYED)
    kf_at = np.zeros(N_DEPLOYED, np.int64)
    t_all0 = time.time()
    for i in range(N_DEPLOYED):
        t0 = time.time()
        jax.block_until_ready(
            s.track_rgbd_pipelined(grays[i], depths[i], i / 30.0)
        )
        times[i] = time.time() - t0
        kf_at[i] = s.stats["kf_inserted"]
    s.finish()
    wall = time.time() - t_all0
    n_kf = int(s.stats["kf_inserted"])
    kf_rate = (n_kf - 1) / max(N_DEPLOYED - 1, 1)  # excl. the init KF
    warm = slice(N_DEPLOYED // 4, None)  # skip compile warm-up
    t_dep = float(np.median(times[warm]) * 1e3)
    t_dep_mean = float(np.mean(times[warm]) * 1e3)
    est = trajectory_positions(s.poses)
    gt = trajectory_positions(poses_gt)
    ate = ate_rmse(est[: len(gt)], gt[: len(est)])
    # KF vs non-KF frame latency split (VERDICT r4 item 3: with the fully
    # async backend no frame should pay a KF-sized spike).
    is_kf = np.diff(np.r_[kf_at[0], kf_at]) > 0
    tw, kw = times[warm] * 1e3, is_kf[warm]
    t_kf = float(np.mean(tw[kw])) if kw.any() else float("nan")
    t_nkf = float(np.mean(tw[~kw])) if (~kw).any() else float("nan")
    log(
        f"deployed (pipelined): median {t_dep:.1f} ms/frame, "
        f"mean {t_dep_mean:.1f}, total {wall:.0f}s, {n_kf} KFs "
        f"(rate {kf_rate:.2f}), ATE {ate*100:.2f} cm"
    )
    log(
        f"deployed KF-frame split: KF frames mean {t_kf:.1f} ms, non-KF "
        f"mean {t_nkf:.1f} ms, mean/median {t_dep_mean/t_dep:.2f}x, "
        f"worst {float(np.max(tw)):.1f} ms"
    )

    # ---- 2. device-bound: scan the SAME deployed frame program -------------
    s._rebuild_snapshot()
    snap, acc = s._snap, s._acc
    gd = jnp.asarray(grays[:N_SCAN], jnp.float32)
    dd = jnp.asarray(depths[:N_SCAN], jnp.float32)

    def step(carry, inp):
        T_prev, vel, a = carry
        g, d = inp
        out = fstep.frame_step(
            cfg, g, d, T_prev, vel,
            jnp.float32(cfg.tracking.motion_match_radius), snap, a,
        )
        return (out.T_cw, out.vel, out.acc), out.summary[fstep.S_INLIERS]

    @jax.jit
    def run(gd, dd, T0):
        (_, _, a), inl = jax.lax.scan(step, (T0, jnp.eye(4), acc), (gd, dd))
        return inl

    T0 = jnp.asarray(s.last.T_cw)
    log("compiling tracking scan...")
    t0 = time.time()
    inl = np.asarray(jax.block_until_ready(run(gd, dd, T0)))
    log(f"compile+first: {time.time()-t0:.1f}s; inliers/frame: {inl[:4]}...")
    reps = 3
    t0 = time.time()
    for _ in range(reps):
        jax.block_until_ready(run(gd, dd, T0))
    t_track = (time.time() - t0) / (reps * N_SCAN)
    log(f"frame_step device: {t_track*1e3:.2f} ms/frame")

    # ---- 3. keyframe-rate backend device cost ----------------------------
    t_backend = _bench_backend(cfg)
    t_eff = t_track + kf_rate * t_backend
    fps = 1.0 / t_eff
    log(
        f"device-bound full system: {t_eff*1e3:.2f} ms/frame "
        f"({t_track*1e3:.2f} track + {kf_rate:.2f} x {t_backend*1e3:.1f} "
        f"backend) = {fps:.1f} frames/s "
        f"(deployed: {1e3/t_dep:.1f} frames/s)"
    )

    base_fps, base_kind = baseline_fps()
    log(
        f"baseline ({base_kind}): {base_fps:.2f} frames/s "
        f"(C++ ORB+LSD+LBD+match hot path, this host)"
    )
    print(
        json.dumps(
            {
                "metric": "rgbd_full_system_throughput",
                "value": round(fps, 2),
                "unit": "frames/s/device",
                "device": jax.devices()[0].device_kind,
                "vs_baseline": round(fps / base_fps, 2),
                "baseline": base_kind,
                "baseline_fps": round(base_fps, 2),
                "deployed_median_ms": round(t_dep, 1),
                "deployed_mean_ms": round(t_dep_mean, 1),
                "deployed_kf_frame_ms": round(t_kf, 1),
                "deployed_non_kf_frame_ms": round(t_nkf, 1),
            }
        )
    )


def _bench_backend(cfg):
    """Device cost of one keyframe's backend: local BA at the typical
    bucketed shape + the batched 10-neighbour epipolar triangulation."""
    import jax
    import jax.numpy as jnp

    from pslam.geometry import project_stereo, se3_exp, transform_points
    from pslam.solver.local_ba import BAProblem, local_bundle_adjustment

    cam = cfg.camera
    caps = cfg.caps
    rng = np.random.default_rng(0)
    # Ladder-calibrated TYPICAL local-BA shape (the 200-frame run holds ~40
    # KFs / ~6k live points; assemble_local_ba buckets shapes to the next
    # power of two -> 8192 edges / 2048 points typical; worst case 16384).
    C, P, E, n_free = caps.ba_cams, 2048, 8192, caps.ba_free
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
    obs = np.asarray(project_stereo(cam, Xc)) + rng.normal(
        0, 0.3, (E, 3)
    ).astype(np.float32)
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

    import time as _t

    def scan_time(fn, *args, R=4):
        @jax.jit
        def loop(*args):
            def body(c, _):
                args_c = jax.tree_util.tree_map(
                    lambda x: x + (c * 1e-30).astype(x.dtype)
                    if jnp.issubdtype(x.dtype, jnp.floating) else x, args)
                out = fn(*args_c)
                sv = sum(jnp.sum(x.astype(jnp.float32))
                         for x in jax.tree_util.tree_leaves(out))
                return c + sv * 1e-20, None
            c, _ = jax.lax.scan(body, jnp.float32(0.0), None, length=R)
            return c
        jax.block_until_ready(loop(*args))
        t0 = _t.time()
        jax.block_until_ready(loop(*args))
        return (_t.time() - t0) / R

    log("compiling local BA...")
    t_ba = scan_time(lambda p: local_bundle_adjustment(cam, p, cfg.caps.ba_free), prob)
    log(f"local BA ({C}c/{P}p/{E}e, 5+10 LM): {t_ba*1e3:.2f} ms")

    from pslam.ops.triangulate import (
        KFView,
        epipolar_triangulate_batch,
    )

    N = cfg.orb.capacity

    def mk_view(c, lead=None):
        shape = (lambda *s: s) if lead is None else (
            lambda *s: (lead,) + s
        )
        return KFView(
            T_cw=jnp.asarray(
                np.broadcast_to(T_cw[c].astype(np.float32), shape(4, 4))
            ),
            uv=jnp.asarray(np.broadcast_to(
                obs[rng.integers(0, E, N), :2].astype(np.float32),
                shape(N, 2))),
            ur=jnp.asarray(np.full(shape(N), -1, np.float32)),
            depth=jnp.asarray(np.broadcast_to(
                rng.uniform(1, 5, N).astype(np.float32), shape(N))),
            level=jnp.zeros(shape(N), jnp.int32),
            angle=jnp.zeros(shape(N), jnp.float32),
            desc=jnp.asarray(np.broadcast_to(
                rng.integers(0, 256, (N, 32), dtype=np.uint8),
                shape(N, 32))),
            free=jnp.ones(shape(N), bool),
        )

    v1 = mk_view(0)
    v2 = mk_view(1, lead=10)
    t_tri = scan_time(
        lambda a, b: epipolar_triangulate_batch(
            cam, a, b, cfg.orb.scale, cfg.orb.levels
        ),
        v1, v2, R=4,
    )
    log(f"batched 10-neighbour triangulation: {t_tri*1e3:.2f} ms")

    return t_ba + t_tri


if __name__ == "__main__":
    main()
