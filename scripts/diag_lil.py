"""Diagnose the +LILs ladder regression (VERDICT r4 item 2).

Runs ONE ladder variant (argv[1]) over the textured loop circuit and prints
a JSON result line. Variants isolate where the LIL composite error hurts:

  points        no lines at all (reference row)
  lines         map lines, no LIL terms
  lils          default (LIL_INFO=0.01 in pose opt + local BA)
  lils_pose     LIL terms in the pose solve only (BA weight -> 0)
  lils_ba       LIL terms in local BA only (pose weight -> 0)
  lils_w<F>     LIL_INFO scaled by F everywhere (e.g. lils_w0.1)

Each variant must run in its OWN process: the weights are module globals
closed over at trace time, and jax's jit cache does not key on them.

Usage: python scripts/diag_lil.py <variant> [n_frames]
Driver: for v in points lines lils lils_pose lils_ba lils_w0.1; do
          python scripts/diag_lil.py $v 160; done
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")

    variant = sys.argv[1]
    n_frames = int(sys.argv[2]) if len(sys.argv) > 2 else 160

    from pslam.solver import ba_lil, lil, pose_opt

    kw = dict(use_lines=True, use_lils=True, use_bow=False,
              use_loop_closing=False)
    if variant == "points":
        kw.update(use_lines=False, use_lils=False)
    elif variant == "lines":
        kw.update(use_lils=False)
    elif variant == "lils":
        pass
    elif variant == "lils_pose":
        ba_lil.LIL_INFO = 0.0
    elif variant == "lils_ba":
        pose_opt.LIL_INFO = 0.0
    elif variant.startswith("lils_w"):
        f = float(variant[len("lils_w"):])
        for mod in (lil, ba_lil, pose_opt):
            mod.LIL_INFO = 0.01 * f
    else:
        raise SystemExit(f"unknown variant {variant!r}")

    from pslam.io.synthetic import (
        ClosedRoom,
        loop_trajectory,
        render_sequence,
    )
    from pslam.pipeline.system import SlamSystem
    from pslam.utils.config import SlamConfig
    from pslam.utils.metrics import ate_rmse, trajectory_positions

    cfg = SlamConfig(**kw)
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
    ate_online = ate_rmse(trajectory_positions(np.stack(est)), gt_pos)
    print(json.dumps(dict(
        variant=variant, n=n_frames, ate_cm=round(ate * 100, 3),
        online_cm=round(ate_online * 100, 3),
        kfs=int(s.stats.get("kf_inserted", 0)),
        lils_alive=int(np.sum(s.map.il_valid)),
        secs=round(dt, 1),
    )), flush=True)


if __name__ == "__main__":
    main()
