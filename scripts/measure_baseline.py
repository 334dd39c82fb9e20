"""Measure the C++ reference-hot-path baseline on THIS host's CPU.

Builds baseline/orb_lsd_baseline.cpp (g++ -O3 -march=native, the reference's
own flags, CMakeLists.txt:10-11), renders the same synthetic sequence the
device bench uses, and times the reference per-frame hot path (ORB 1000/8
levels + LSD/LBD lines + Hamming matching — see the .cpp header for the
file:line mapping and why this UNDERSTATES the full reference frame cost).

Writes BASELINE_MEASURED.json at the repo root; bench.py uses it as the
vs_baseline denominator (replacing the round<=4 assumed 20 fps).

Run: python scripts/measure_baseline.py [--frames N] [--force]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "baseline", "orb_lsd_baseline.cpp")
BIN = os.path.join(REPO, "baseline", "orb_lsd_baseline")
OUT = os.path.join(REPO, "BASELINE_MEASURED.json")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build() -> bool:
    if os.path.exists(BIN) and os.path.getmtime(BIN) >= os.path.getmtime(SRC):
        return True
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++14", SRC, "-o", BIN,
        "-I/usr/include/opencv4",
        "-lopencv_core", "-lopencv_imgproc", "-lopencv_imgcodecs",
        "-lopencv_features2d", "-lopencv_line_descriptor",
    ]
    log("building:", " ".join(cmd))
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        log(r.stderr)
        return False
    return True


def write_pgm(path: str, img):
    import numpy as np

    a = np.clip(img, 0, 255).astype(np.uint8)
    h, w = a.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(a.tobytes())


def measure(n_frames: int) -> dict | None:
    if not build():
        return None
    from pslam.io.synthetic import render_sequence
    from pslam.utils.config import SlamConfig

    cfg = SlamConfig()
    log(f"rendering {n_frames} frames (same scene/trajectory as bench.py)...")
    grays, _, _ = render_sequence(cfg.camera, n_frames=n_frames, seed=0)
    with tempfile.TemporaryDirectory() as d:
        for i, g in enumerate(grays):
            write_pgm(os.path.join(d, f"{i:06d}.pgm"), g)
        log("running baseline binary...")
        r = subprocess.run(
            [BIN, d, str(n_frames)], capture_output=True, text=True,
            timeout=1200,
        )
        if r.returncode != 0:
            log(r.stderr)
            return None
        log(r.stderr.strip())
        res = json.loads(r.stdout.strip().splitlines()[-1])
    import platform

    res.update(
        {
            "baseline": "measured",
            "what": "reference per-frame hot path: cv::ORB 1000/8 levels + "
            "LSD/LBD lines + Hamming kNN matching (see baseline/"
            "orb_lsd_baseline.cpp for file:line mapping); EXCLUDES the "
            "reference's per-line 3D RANSAC, fan detection, and 2x g2o pose "
            "optimization per frame, so fps here is an upper bound on the "
            "reference (conservative vs_baseline denominator)",
            "host": platform.processor() or "x86_64",
            "nproc": os.cpu_count(),
            "flags": "-O3 -march=native (CMakeLists.txt:10-11)",
        }
    )
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()
    if os.path.exists(OUT) and not args.force:
        log(f"{OUT} exists; --force to re-measure")
        print(open(OUT).read())
        return
    res = measure(args.frames)
    if res is None:
        log("baseline measurement FAILED")
        sys.exit(1)
    with open(OUT, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
