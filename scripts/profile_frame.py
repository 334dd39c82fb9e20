"""Stage-level profiling of the per-frame hot path on the default device.

Each stage runs R times inside one jitted lax.scan so per-dispatch overhead
is amortized; timing ends in block_until_ready on the final carry. Prints
ms/iteration per stage.
"""

import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


R = 20


def timeit(name, fn, *args):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def loop(*args):
        def body(c, _):
            # Perturb every float input by the carry so the stage cannot be
            # hoisted out of the scan as loop-invariant.
            def perturb(x):
                if jnp.issubdtype(x.dtype, jnp.floating):
                    return x + (c * 1e-30).astype(x.dtype)
                return x

            args_c = jax.tree_util.tree_map(perturb, args)
            out = fn(*args_c)
            # Fold outputs into a scalar so nothing is dead code.
            leaves = jax.tree_util.tree_leaves(out)
            s = sum(jnp.sum(x.astype(jnp.float32)) for x in leaves if x.size)
            return c + s * 1e-20, None

        c, _ = jax.lax.scan(body, jnp.float32(0.0), None, length=R)
        return c

    jax.block_until_ready(loop(*args))  # compile
    t0 = time.time()
    jax.block_until_ready(loop(*args))
    dt = (time.time() - t0) / R * 1e3
    log(f"{name:34s} {dt:8.3f} ms")
    return dt


def main():
    import jax
    import jax.numpy as jnp

    from pslam.io.synthetic import render_sequence
    from pslam.ops.fast import fast_score, nms3x3
    from pslam.ops.image import build_pyramid, gaussian_blur
    from pslam.ops import orb as orb_mod
    from pslam.ops.orb import extract_orb, extract_patches, keypoint_angles
    from pslam.pipeline.frame_ops import make_frame, make_frame_lines
    from pslam.pipeline.track_ops import (
        PointSet,
        track_against_points,
        track_local_map_step,
    )
    from pslam.utils.config import SlamConfig

    cfg = SlamConfig()
    cam, orb = cfg.camera, cfg.orb
    log("device:", jax.devices()[0])

    grays, depths, poses_gt = render_sequence(cam, n_frames=2, seed=0)
    img = jnp.asarray(grays[0])
    depth = jnp.asarray(depths[0])

    stack, level_scale, _ = build_pyramid(img, orb.levels, orb.scale)
    stack = jax.block_until_ready(stack)

    from pslam.ops.fast import fast_score_dual
    from pslam.ops.orb import detect_keypoints

    timeit("build_pyramid", lambda x: build_pyramid(x, orb.levels, orb.scale)[0], img)
    timeit(
        "fast_dual",
        lambda s: fast_score_dual(s, orb.th_fast_hi, orb.th_fast_lo),
        stack,
    )
    timeit(
        "nms3x3",
        lambda s: nms3x3(fast_score(s, orb.th_fast_lo)[1]),
        stack,
    )
    h, w = img.shape
    timeit("detect_keypoints", lambda s: detect_keypoints(s, orb, h, w), stack)
    timeit("gaussian_blur", gaussian_blur, stack)

    feats = jax.block_until_ready(extract_orb(img, orb))
    blurred = jax.block_until_ready(gaussian_blur(stack))
    timeit(
        "extract_patches",
        lambda b, u, l: extract_patches(b, u, l),
        blurred,
        feats.uv_lvl,
        feats.level,
    )
    bpatch = jax.block_until_ready(
        extract_patches(blurred, feats.uv_lvl, feats.level)
    )
    timeit("keypoint_angles", keypoint_angles, bpatch)
    timeit("brief_bits", orb_mod._brief_bits, bpatch, feats.angle)
    timeit("extract_orb (full)", lambda x: extract_orb(x, orb), img)
    timeit("make_frame", lambda i, d: make_frame(i, d, cam, orb), img, depth)
    timeit(
        "make_frame_lines",
        lambda i, d: make_frame_lines(i, d, cam, cfg.lines),
        img,
        depth,
    )

    # Tracking stages against a realistic map.
    fd0 = jax.block_until_ready(make_frame(img, depth, cam, orb))
    M = cfg.caps.local_points
    has = np.asarray((fd0.depth > 0) & fd0.valid)
    sel = np.flatnonzero(has)[:M]
    pos = np.zeros((M, 3), np.float32)
    pos[: len(sel)] = np.asarray(fd0.xyz_c)[sel]
    desc = np.zeros((M, 32), np.uint8)
    desc[: len(sel)] = np.asarray(fd0.desc)[sel]
    dist = np.linalg.norm(pos, axis=-1)
    pts = PointSet(
        pos=jnp.asarray(pos),
        desc=jnp.asarray(desc),
        level=jnp.zeros(M, jnp.int32),
        angle=jnp.zeros(M, jnp.float32),
        min_dist=jnp.asarray((dist * 0.2).astype(np.float32)),
        max_dist=jnp.asarray((dist * 5.0 + 1.0).astype(np.float32)),
        normal=jnp.asarray(
            pos / np.maximum(dist[:, None], 1e-9).astype(np.float32)
        ),
        valid=jnp.asarray(np.arange(M) < len(sel)),
    )
    T0 = jnp.eye(4, dtype=jnp.float32)
    t_cfg = cfg.tracking
    timeit(
        "track_against_points",
        lambda T, f: track_against_points(
            cam, T, pts, f, t_cfg.motion_match_radius, orb.scale, orb.levels
        ),
        T0,
        fd0,
    )
    timeit(
        "track_local_map_step",
        lambda T, f: track_local_map_step(
            cam, T, pts, f, jnp.full(M, -1, jnp.int32),
            t_cfg.local_match_radius, orb.scale, orb.levels,
        ),
        T0,
        fd0,
    )


if __name__ == "__main__":
    main()
