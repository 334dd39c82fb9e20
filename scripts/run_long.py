"""Long-sequence robustness run (VERDICT r2 item 8): a fr2-length synthetic
circuit (default 500 frames, 2 revisit loops) through the FULL config
(lines + LILs + BoW + loop closing), verifying the run completes within
fixed capacities (with graceful eviction if hit) and reports stable ATE.

Usage: python scripts/run_long.py [n_frames] [--cpu]

By default the run uses JAX's default backend and drives the depth-1
pipelined tracking API, as a deployment would. ``--cpu`` forces the CPU and
the synchronous ``track_rgbd`` API.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    import jax

    on_cpu = "--cpu" in sys.argv
    if on_cpu:
        jax.config.update("jax_platforms", "cpu")
    else:
        from pslam.utils.backend import enable_compile_cache

        enable_compile_cache()
    import numpy as np

    from pslam.io.synthetic import ClosedRoom, loop_trajectory, render_sequence
    from pslam.pipeline.system import SlamSystem
    from pslam.utils.config import SlamConfig
    from pslam.utils.metrics import ate_rmse, trajectory_positions

    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    n = int(args[0]) if args else 500
    cfg = SlamConfig()
    print(f"rendering {n}-frame double-loop sequence...", flush=True)
    poses = loop_trajectory(n, loops=2.0)
    room = ClosedRoom(depth=5.0, half_w=3.0, half_h=2.0, seed=9)
    grays, depths, poses_gt = render_sequence(cfg.camera, poses=poses, room=room)

    sys_ = SlamSystem(cfg)
    track = sys_.track_rgbd if on_cpu else sys_.track_rgbd_pipelined
    t0 = time.time()
    for i in range(n):
        track(grays[i], depths[i], i / 30.0)
        if (i + 1) % 100 == 0:
            m = sys_.map
            print(
                f"frame {i+1}: kfs={int(m.kf_valid.sum())} "
                f"pts={int(m.mp_valid.sum())} lines={int(m.ml_valid.sum())} "
                f"lils={int(m.il_valid.sum())} "
                f"loops={sys_.loop_closer.stats['closed']} "
                f"({time.time()-t0:.0f}s)",
                flush=True,
            )
    sys_.finish()  # drain the pipelined frame + async backend work
    fixed = [sys_._abs_pose(T_rel, ref) for _, T_rel, ref in sys_.trajectory]
    ate = ate_rmse(
        trajectory_positions(np.stack(fixed)),
        trajectory_positions(poses_gt)[: len(fixed)],
    )
    st = sys_.stats
    lc = sys_.loop_closer.stats
    print(
        f"DONE {n} frames in {time.time()-t0:.0f}s: ATE={ate*100:.2f} cm, "
        f"kf_inserted={st.get('kf_inserted')}, kf_culled={st.get('kf_culled', 0)}, "
        f"loops={lc['closed']}, relocs={st.get('relocs', 0)}, "
        f"resets={st.get('resets', 0)}",
        flush=True,
    )
    assert ate < 0.10, f"ATE {ate} too high"
    print("LONG RUN OK")


if __name__ == "__main__":
    main()
