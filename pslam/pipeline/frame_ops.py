"""Per-frame device programs: feature extraction + RGB-D stereo + lines.

Replaces the Frame RGB-D constructor pipeline (reference src/Frame.cc:133-210:
ExtractORB -> ExtractLSD -> UndistortKeyPoints -> ComputeStereoFromRGBD ->
grid assignment) with fused jit calls. No feature grid is built — matching
uses masked distance matrices instead (ops/match.py, ops/line_match.py).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from pslam.geometry import Camera, backproject, undistort_points
from pslam.ops.fans import LILFeatures, build_lils
from pslam.ops.image import gather_pixels_matmul
from pslam.ops.lbd import line_descriptors
from pslam.ops.line3d import fit_lines_3d
from pslam.ops.lines import LineConfig, detect_lines
from pslam.ops.orb import OrbConfig, OrbFeatures, extract_orb


class FrameData(NamedTuple):
    """Device-side frame: SoA features + stereo depth (capacity N)."""

    uv: jnp.ndarray  # (N, 2) undistorted level-0 pixel coords
    ur: jnp.ndarray  # (N,) virtual right-image u, -1 if no depth
    depth: jnp.ndarray  # (N,) z in meters, 0 if invalid
    xyz_c: jnp.ndarray  # (N, 3) camera-frame backprojection (0 if no depth)
    level: jnp.ndarray  # (N,) int32
    angle: jnp.ndarray  # (N,)
    desc: jnp.ndarray  # (N, 32) uint8
    valid: jnp.ndarray  # (N,) bool


@partial(jax.jit, static_argnames=("cam", "orb_cfg"))
def make_frame(img, depth_img, cam: Camera, orb_cfg: OrbConfig) -> FrameData:
    """img (H, W) float32 [0..255]; depth_img (H, W) float32 meters (0=hole).

    Depth is sampled at the *raw* (distorted) keypoint location like
    Frame::ComputeStereoFromRGBD (Frame.cc:1342-1363), then keypoints are
    undistorted for all geometric use.
    """
    feats: OrbFeatures = extract_orb(img, orb_cfg)
    z = gather_pixels_matmul(depth_img, feats.uv[:, 1], feats.uv[:, 0])
    has_depth = (z > 0.05) & feats.valid
    uv = undistort_points(cam, feats.uv)
    z_safe = jnp.where(has_depth, z, 1.0)
    ur = jnp.where(has_depth, uv[:, 0] - cam.bf / z_safe, -1.0)
    xyz_c = backproject(cam, uv, z) * has_depth[:, None]
    return FrameData(
        uv=uv,
        ur=ur,
        depth=jnp.where(has_depth, z, 0.0),
        xyz_c=xyz_c,
        level=feats.level,
        angle=feats.angle,
        desc=feats.desc,
        valid=feats.valid,
    )


@partial(jax.jit, static_argnames=("cam", "orb_cfg"))
def make_frame_stereo(
    img_l, img_r, cam: Camera, orb_cfg: OrbConfig
) -> FrameData:
    """Stereo frame construction (Frame stereo ctor, Frame.cc:56-131 +
    ComputeStereoMatches Frame.cc:1165): extract ORB in BOTH images, match
    left->right along the epipolar rows with sub-pixel SAD refinement
    (ops/stereo.py), and emit the same FrameData the RGB-D path produces
    (ur/depth per left feature) so tracking/mapping downstream is shared.
    The reference extracts the two images on two std::threads
    (Frame.cc:92-93); here both extractions are one fused device program."""
    from pslam.ops.stereo import compute_stereo_matches

    featsL: OrbFeatures = extract_orb(img_l, orb_cfg)
    featsR: OrbFeatures = extract_orb(img_r, orb_cfg)
    ur, z = compute_stereo_matches(
        cam, img_l, img_r,
        featsL.uv, featsL.level, featsL.desc, featsL.valid,
        featsR.uv, featsR.level, featsR.desc, featsR.valid,
        orb_cfg.scale, orb_cfg.levels,
    )
    has_depth = (z > 0.05) & featsL.valid
    uv = undistort_points(cam, featsL.uv)
    # ur was measured on the raw image row; shift it by the undistortion of
    # the left u (rectified stereo assumption: same distortion both views).
    ur_u = jnp.where(has_depth, ur + (uv[:, 0] - featsL.uv[:, 0]), -1.0)
    xyz_c = backproject(cam, uv, z) * has_depth[:, None]
    return FrameData(
        uv=uv,
        ur=ur_u,
        depth=jnp.where(has_depth, z, 0.0),
        xyz_c=xyz_c,
        level=featsL.level,
        angle=featsL.angle,
        desc=featsL.desc,
        valid=featsL.valid,
    )


class FrameLineData(NamedTuple):
    """Device-side line features of one frame (capacity NL) + LIL set.

    Mirrors the line part of the Frame ctor (ExtractLSD + isLineGood + fan
    detection + plane build, Frame.cc:489-646).
    """

    sp: jnp.ndarray  # (NL, 2)
    ep: jnp.ndarray  # (NL, 2)
    eq2d: jnp.ndarray  # (NL, 3) normalized image-line equations
    angle: jnp.ndarray  # (NL,)
    length: jnp.ndarray  # (NL,)
    desc: jnp.ndarray  # (NL, D) float band descriptors
    valid: jnp.ndarray  # (NL,)
    p3s: jnp.ndarray  # (NL, 3) camera-frame 3D endpoints (mvLines3D)
    p3e: jnp.ndarray  # (NL, 3)
    dir3d: jnp.ndarray  # (NL, 3) normalized 3D direction (mvLineEq)
    ok3d: jnp.ndarray  # (NL,)
    lil: LILFeatures  # structural-line hypotheses


@partial(jax.jit, static_argnames=("cam", "line_cfg", "n_lil"))
def make_frame_lines(
    img, depth_img, cam: Camera, line_cfg: LineConfig, n_lil: int = 64
) -> FrameLineData:
    """The line half of the per-frame frontend, one fused dispatch."""
    lf = detect_lines(img, line_cfg)
    desc = line_descriptors(img, lf.sp, lf.ep, lf.valid)
    p3s, p3e, d3, ok3 = fit_lines_3d(cam, depth_img, lf.sp, lf.ep, lf.valid)
    lil = build_lils(
        lf.sp, lf.ep, lf.eq2d, lf.valid, p3s, p3e, d3, ok3,
        n_lil=n_lil, width=cam.width, height=cam.height,
    )
    return FrameLineData(
        sp=lf.sp, ep=lf.ep, eq2d=lf.eq2d, angle=lf.angle, length=lf.length,
        desc=desc, valid=lf.valid, p3s=p3s, p3e=p3e, dir3d=d3, ok3d=ok3,
        lil=lil,
    )
