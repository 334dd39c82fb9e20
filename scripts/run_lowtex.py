"""Low-texture scenario: do lines/LILs carry tracking where points starve?

BASELINE config 2 (fr3_structure_notexture analogue; reference README.md:4
claims PSL-SLAM's value is exactly this scene class). Renders a
LowTextureRoom sequence (large uniform panels: few corners, long
high-contrast straight borders) and runs the ladder:

  points   points only               -> expected to starve / drift badly
  +lines   map lines, no LIL terms
  +LILs    full structural-line composite error

Prints one JSON line per config and appends a table to RESULTS.md when
--write is given. Usage: python scripts/run_lowtex.py [n_frames] [--write]
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def run_one(name, kw, grays, depths, gt_pos, n_frames):
    from pslam.pipeline.system import SlamSystem
    from pslam.utils.config import SlamConfig
    from pslam.utils.metrics import ate_rmse, trajectory_positions

    cfg = SlamConfig(**kw)
    s = SlamSystem(cfg)
    t0 = time.time()
    est = []
    for i in range(n_frames):
        est.append(np.asarray(s.track_rgbd(grays[i], depths[i], i / 30.0)))
    s.finish()
    dt = time.time() - t0
    fixed = [s._abs_pose(T_rel, ref) for _, T_rel, ref in s.trajectory]
    est_pos = trajectory_positions(np.stack(fixed))
    ate = ate_rmse(est_pos, gt_pos[: len(est_pos)])
    ate_online = ate_rmse(trajectory_positions(np.stack(est)), gt_pos)
    st = s.stats
    row = dict(
        name=name, ate_cm=round(ate * 100, 2),
        online_cm=round(ate_online * 100, 2),
        kfs=int(st.get("kf_inserted", 0)),
        lost=int(st.get("lost_events", st.get("relocs", 0))) +
             int(st.get("resets", 0)),
        relocs=int(st.get("relocs", 0)), resets=int(st.get("resets", 0)),
        secs=round(dt, 1),
    )
    print(json.dumps(row), flush=True)
    return row


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")

    from pslam.io.synthetic import (
        LowTextureRoom,
        loop_trajectory,
        render_sequence,
    )
    from pslam.utils.config import SlamConfig
    from pslam.utils.metrics import trajectory_positions

    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    n_frames = int(args[0]) if args else 120
    write = "--write" in sys.argv

    cfg0 = SlamConfig()
    print(f"rendering {n_frames}-frame low-texture sequence...", flush=True)
    poses = loop_trajectory(n_frames, loops=1.0)
    room = LowTextureRoom(depth=5.0, half_w=3.0, half_h=2.0, seed=5)
    grays, depths, poses_gt = render_sequence(cfg0.camera, poses=poses,
                                              room=room)
    gt_pos = trajectory_positions(poses_gt)

    ladder = [
        ("points", dict(use_lines=False, use_bow=False,
                        use_loop_closing=False)),
        ("+lines", dict(use_lines=True, use_lils=False, use_bow=False,
                        use_loop_closing=False)),
        ("+LILs", dict(use_lines=True, use_lils=True, use_bow=False,
                       use_loop_closing=False)),
    ]
    rows = [run_one(n, kw, grays, depths, gt_pos, n_frames)
            for n, kw in ladder]

    if write:
        out = os.path.join(os.path.dirname(__file__), "..", "RESULTS.md")
        with open(out, "a") as f:
            f.write(
                f"\n## Low-texture scene ({n_frames} frames, LowTextureRoom"
                " — BASELINE config 2, fr3_structure_notexture analogue)\n\n"
                "Large uniform panels: few corners, long straight borders.\n"
                "The scene class the reference's composite line error"
                " exists for.\n\n"
                "| config | ATE RMSE (cm) | online (cm) | keyframes |"
                " relocs | resets |\n|---|---|---|---|---|---|\n"
            )
            for r in rows:
                f.write(
                    f"| {r['name']} | {r['ate_cm']:.2f} | "
                    f"{r['online_cm']:.2f} | {r['kfs']} | {r['relocs']} | "
                    f"{r['resets']} |\n"
                )
            f.write(f"\nGenerated by scripts/run_lowtex.py, "
                    f"{time.strftime('%Y-%m-%d')}.\n")
        print(f"appended to {os.path.abspath(out)}")


if __name__ == "__main__":
    main()
