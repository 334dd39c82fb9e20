"""Quick frame_step device-time measurement (the bench.py chip-bound leg,
without the 120-frame deployed warm-up): builds a real map from a short
sequence, then scans the fused frame_step program.

Run: python scripts/bench_frame_step.py
"""

import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


N_WARM = 12
N_SCAN = 16


def main():
    import jax

    from pslam.utils.backend import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp

    from pslam.io.synthetic import render_sequence
    from pslam.pipeline import frame_step as fstep
    from pslam.pipeline.system import SlamSystem
    from pslam.utils.config import SlamConfig

    cfg = SlamConfig()
    log("device:", jax.devices()[0])
    grays, depths, _ = render_sequence(
        cfg.camera, n_frames=N_WARM + N_SCAN, seed=0
    )
    s = SlamSystem(cfg)
    t0 = time.time()
    for i in range(N_WARM):
        s.track_rgbd(grays[i], depths[i], i / 30.0)
    log(f"warmed map in {time.time()-t0:.0f}s: {s.map.n_kf} KFs")
    s._rebuild_snapshot()
    snap, acc = s._snap, s._acc
    gd = jnp.asarray(grays[N_WARM:], jnp.float32)
    dd = jnp.asarray(depths[N_WARM:], jnp.float32)

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
    t0 = time.time()
    inl = np.asarray(jax.block_until_ready(run(gd, dd, T0)))
    log(f"compile+first: {time.time()-t0:.1f}s; inliers: {inl[:6]}")
    reps = 4
    t0 = time.time()
    for _ in range(reps):
        jax.block_until_ready(run(gd, dd, T0))
    t = (time.time() - t0) / (reps * N_SCAN)
    log(f"frame_step device: {t*1e3:.3f} ms/frame")
    print(f"{t*1e3:.3f}")


if __name__ == "__main__":
    main()
