"""Loop-closing evaluation on the default device: drive the full system around
the ClosedRoom loop circuit (the RESULTS.md ladder scene) and report
corrected-vs-online ATE plus the innovation-blend diagnostics.

Usage: python scripts/eval_loop.py [n_frames ...] (default: 160 200)
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def run(n_frames: int):
    from pslam.io.synthetic import (
        ClosedRoom,
        loop_trajectory,
        render_sequence,
    )
    from pslam.pipeline.system import SlamSystem
    from pslam.utils.config import SlamConfig
    from pslam.utils.metrics import ate_rmse, trajectory_positions

    cfg = SlamConfig()
    poses = loop_trajectory(n_frames, loops=1.0)
    room = ClosedRoom(depth=5.0, half_w=3.0, half_h=2.0, seed=3)
    grays, depths, poses_gt = render_sequence(cfg.camera, poses=poses,
                                              room=room)
    gt_pos = trajectory_positions(poses_gt)

    s = SlamSystem(cfg)
    t0 = time.time()
    est = []
    for i in range(n_frames):
        est.append(np.asarray(s.track_rgbd(grays[i], depths[i], i / 30.0)))
    s.finish()
    dt = time.time() - t0
    fixed = [s._abs_pose(T_rel, ref) for _, T_rel, ref in s.trajectory]
    ate = ate_rmse(trajectory_positions(np.stack(fixed)),
                   gt_pos[: len(fixed)])
    online = ate_rmse(trajectory_positions(np.stack(est)), gt_pos)
    lc = s.loop_closer.stats if s.loop_closer else {}
    print(json.dumps(dict(
        n=n_frames, ate_cm=round(ate * 100, 2),
        online_cm=round(online * 100, 2),
        loops_closed=int(lc.get("closed", 0)),
        loops_detected=int(lc.get("detected", 0)),
        fuse_only=int(lc.get("fuse_only", 0)),
        blend_alpha=round(float(lc.get("blend_alpha", -1)), 3),
        gate=(int(lc.get("gate_corr", -1)), int(lc.get("gate_cur", -1))),
        secs=round(dt, 1),
    )), flush=True)


def main():
    ns = [int(a) for a in sys.argv[1:]] or [160, 200]
    from pslam.utils.backend import enable_compile_cache

    enable_compile_cache()
    for n in ns:
        run(n)


if __name__ == "__main__":
    main()
