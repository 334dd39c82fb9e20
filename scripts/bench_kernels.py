"""A/B of the hand-written Pallas pose-terms kernel (ops/pallas_pose.py)
against the plain XLA path on the GPU.

1. alone, at the 4096-edge tracking width: one evaluation of the edge terms,
   and the whole 4x10 LM solve;
2. end to end in ``frame_step``: one warm frame at full SlamConfig() width,
   median of 30, plain and kernel in turns (plain, kernel, kernel, plain);
3. a profiler trace of three warm frames per variant, reduced to kernels per
   frame, device busy time and idle share, and the top kernels.

Usage: python scripts/bench_kernels.py
"""

from __future__ import annotations

import glob
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def log(*a):
    print(*a, flush=True)


def med_ms(f, *args, n=50):
    import jax

    jax.block_until_ready(f(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts)), 1e3 * float(np.percentile(ts, 90))


def pose_alone():
    import jax
    import jax.numpy as jnp

    from pslam.io.problems import pose_problem
    from pslam.ops.pallas_pose import (
        pack_pose_data, pack_pose_params, pose_terms_fused,
    )
    from pslam.solver import pose_opt
    from pslam.utils.config import SlamConfig

    cam = SlamConfig().camera
    po, T = pose_problem(cam, 4096, seed=1, outlier_frac=0.1)
    Tj = jnp.asarray(T)

    @jax.jit
    def plain_terms(T):
        chi2, w, r, J, rm, cost = pose_opt._edge_terms(
            cam, T, po, True, po.valid)
        return (*pose_opt._gn_system(w, r, J, rm), cost, chi2)

    @jax.jit
    def fused_terms(T):
        return pose_terms_fused(pack_pose_data(po),
                                pack_pose_params(cam, T, jnp.asarray(1.0)))

    tp = med_ms(plain_terms, Tj)
    tf = med_ms(fused_terms, Tj)
    log(f"pose terms alone (E=4096): plain XLA {tp[0]:.4f} ms, "
        f"Pallas/Triton {tf[0]:.4f} ms")

    T0 = jnp.eye(4, dtype=jnp.float32)
    solve = {
        name: jax.jit(lambda T, f=f: f(cam, T, po, 4, 10, None))
        for name, f in (("plain", pose_opt._pose_optimization_plain),
                        ("kernel", pose_opt._pose_optimization_fused))
    }
    for name in ("plain", "kernel", "kernel", "plain"):
        t = med_ms(solve[name], T0, n=30)
        log(f"pose LM 4x10 alone [{name}]: {t[0]:.3f} ms (p90 {t[1]:.3f})")


def trace_summary(tag, fn, n=3):
    """Trace n warm calls; print kernels per frame, busy time, idle share
    and the top kernels by device time."""
    import jax

    jax.block_until_ready(fn())
    with tempfile.TemporaryDirectory() as path:
        with jax.profiler.trace(path):
            for _ in range(n):
                jax.block_until_ready(fn())
        files = glob.glob(os.path.join(path, "plugins/profile/*/*.xplane.pb"))
        pd = jax.profiler.ProfileData.from_file(sorted(files)[-1])
        planes = [p for p in pd.planes if p.name.startswith("/device:GPU")]
        for plane in planes:
            names, spans = {}, []
            for line in plane.lines:
                if not line.name.startswith("Stream"):
                    continue
                for e in line.events:
                    names.setdefault(e.name, []).append(e.duration_ns)
                    spans.append((e.start_ns, e.start_ns + e.duration_ns))
            if not spans:
                continue
            spans.sort()
            busy, cur_s, cur_e = 0, spans[0][0], spans[0][1]
            for s, e in spans[1:]:
                if s > cur_e:
                    busy += cur_e - cur_s
                    cur_s, cur_e = s, e
                else:
                    cur_e = max(cur_e, e)
            busy += cur_e - cur_s
            window = spans[-1][1] - spans[0][0]
            n_k = sum(len(v) for v in names.values())
            log(f"[{tag}] {plane.name}: {n_k / n:.0f} kernels/frame, busy "
                f"{busy / n / 1e6:.3f} ms/frame of a {window / n / 1e6:.3f} "
                f"ms window (idle share {1 - busy / window:.3f})")
            top = sorted(names.items(), key=lambda kv: -sum(kv[1]))[:15]
            for name, ds in top:
                log(f"    {sum(ds) / n / 1e3:9.1f} us/frame  x{len(ds) / n:6.1f}"
                    f"  {name[:100]}")


def frame_step_ab():
    import jax
    import jax.numpy as jnp

    from pslam.io.synthetic import render_sequence
    from pslam.pipeline import frame_step as fstep
    from pslam.pipeline import track_ops
    from pslam.pipeline.system import SlamSystem
    from pslam.solver import pose_opt
    from pslam.utils.config import SlamConfig

    def use(name):
        """Send frame_step's pose solves down one path; retrace."""
        f = (pose_opt._pose_optimization_fused if name == "kernel"
             else pose_opt._pose_optimization_plain)
        track_ops.pose_optimization = (
            lambda cam, T, po, rounds=4, iters=10, lil=None:
            f(cam, T, po, rounds, iters, lil))
        jax.clear_caches()

    cfg = SlamConfig()
    n_warm = 20
    grays, depths, _ = render_sequence(cfg.camera, n_frames=n_warm + 1, seed=0)
    s = SlamSystem(cfg)
    t0 = time.perf_counter()
    for i in range(n_warm):
        s.track_rgbd(grays[i], depths[i], i / 30.0)
    log(f"warm-up: {n_warm} frames in {time.perf_counter() - t0:.1f} s, "
        f"{s.map.n_kf} KFs")
    s.flush()
    s._rebuild_snapshot()
    g = jnp.asarray(grays[n_warm], jnp.float32)
    d = jnp.asarray(depths[n_warm], jnp.float32)
    T0 = jnp.asarray(s.last.T_cw)
    V0 = jnp.asarray(s.velocity)

    def call():
        return fstep.frame_step(
            cfg, g, d, T0, V0, cfg.tracking.motion_match_radius,
            s._snap, s._acc,
        )

    ref = None
    for name in ("plain", "kernel", "kernel", "plain"):
        use(name)
        summ = np.asarray(jax.block_until_ready(call()).summary)
        ref = summ if ref is None else ref
        ms = med_ms(call, n=30)
        log(f"frame_step [{name}]: {ms[0]:.3f} ms median (p90 {ms[1]:.3f}), "
            f"inliers {summ[fstep.S_INLIERS]:.0f}, max |dT| vs plain "
            f"{np.abs(summ[fstep.S_T] - ref[fstep.S_T]).max():.2e}")
    for name in ("plain", "kernel"):
        use(name)
        trace_summary(name, call)
    track_ops.pose_optimization = pose_opt.pose_optimization


def main():
    import jax

    from pslam.utils.backend import enable_compile_cache

    if jax.default_backend() != "gpu":
        sys.exit("bench_kernels.py measures the GPU; no GPU found")
    log("device:", jax.devices()[0].device_kind, "| cache:",
        enable_compile_cache())
    log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    pose_alone()
    frame_step_ab()


if __name__ == "__main__":
    main()
