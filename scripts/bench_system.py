"""Deployed-system benchmark: drive SlamSystem.track_rgbd end-to-end on the
default device (VERDICT r3 item 2 — the scan bench measures the device program;
this measures what a user actually gets, host orchestration included).

Usage: python scripts/bench_system.py [n_frames]
Prints per-frame wall-time stats (median/mean/p90) excluding the compile
warm-up, plus keyframe-frame vs non-keyframe-frame latency split.
"""

import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(n_frames: int = 100):
    sys.path.insert(0, "/root/repo")
    import jax

    from pslam.utils.backend import enable_compile_cache
    enable_compile_cache()

    from pslam.io.synthetic import render_sequence
    from pslam.pipeline.system import SlamSystem
    from pslam.utils.config import SlamConfig
    from pslam.utils.metrics import ate_rmse, trajectory_positions

    cfg = SlamConfig()
    log("device:", jax.devices()[0])
    log(f"rendering {n_frames} frames...")
    grays, depths, poses_gt = render_sequence(
        cfg.camera, n_frames=n_frames, seed=0
    )

    sys_ = SlamSystem(cfg)
    times = []
    kf_counts = []
    t_start = time.time()
    for i in range(n_frames):
        t0 = time.time()
        sys_.track_rgbd(grays[i], depths[i], i / 30.0)
        times.append(time.time() - t0)
        kf_counts.append(sys_.stats["kf_inserted"])
    total = time.time() - t_start

    times = np.asarray(times)
    kf_counts = np.asarray(kf_counts)
    was_kf = np.diff(kf_counts, prepend=0) > 0
    warm = np.zeros(len(times), bool)
    warm[:10] = True  # compile warm-up frames

    t = times[~warm] * 1e3
    t_kf = times[was_kf & ~warm] * 1e3
    t_no = times[~was_kf & ~warm] * 1e3
    log(f"total wall: {total:.1f}s for {n_frames} frames "
        f"({sys_.stats['kf_inserted']} KFs)")
    log(f"steady-state ms/frame: median {np.median(t):.1f} mean {t.mean():.1f} "
        f"p90 {np.percentile(t, 90):.1f}")
    if len(t_kf):
        log(f"  KF frames   ({len(t_kf)}): median {np.median(t_kf):.1f} "
            f"mean {t_kf.mean():.1f}")
    if len(t_no):
        log(f"  non-KF      ({len(t_no)}): median {np.median(t_no):.1f} "
            f"mean {t_no.mean():.1f}")
    log(f"stats: {sys_.stats}")
    est = sys_.poses
    n = min(len(est), len(poses_gt))
    ate = ate_rmse(
        trajectory_positions(est[:n]), trajectory_positions(poses_gt[:n])
    )
    log(f"ATE RMSE: {ate*100:.2f} cm")
    print(
        f'{{"deployed_ms_per_frame": {np.median(t):.2f}, '
        f'"mean_ms": {t.mean():.2f}, "ate_cm": {ate*100:.2f}}}'
    )


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 100)
