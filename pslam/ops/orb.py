"""Oriented-FAST + rotated-BRIEF extraction as one batched device program.

Replaces ORBextractor (reference src/ORBextractor.cc) end to end:

- ComputeKeyPointsOctTree (765): per-cell FAST with high->low threshold
  fallback becomes full-stack FAST at both thresholds + a per-cell fallback
  mask; DistributeOctTree's sequential quadtree (539) becomes grid-bucketed
  per-cell top-k followed by per-level top-quota — same goal (spatially
  spread, response-ranked, scale-distributed keypoints) without data-
  dependent control flow.
- IC_Angle (77): per-keypoint circular-patch moments become two 31x31
  convolutions over the whole stack sampled at keypoint locations.
- computeOrbDescriptor (108): 256 learned pairs are replaced by a seeded
  Gaussian pattern (BRIEF-style); bits are gathered from the blurred stack
  with per-keypoint rotated offsets and packed to uint8[32].

The descriptor pattern differs bit-for-bit from OpenCV's learned table (we
do not copy it); matching is internal to this framework so only
self-consistency matters. Pattern quality is validated by the matching tests
(viewpoint/rotation invariance).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from pslam.ops.fast import fast_score_dual, nms3x3
from pslam.ops.image import build_pyramid, gaussian_blur

HALF_PATCH = 15  # reference HALF_PATCH_SIZE (ORBextractor.cc:73)
EDGE = 16  # reference minBorder = EDGE_THRESHOLD-3 (ORBextractor.cc:771-774)


@dataclasses.dataclass(frozen=True)
class OrbConfig:
    n_features: int = 1000
    levels: int = 8
    scale: float = 1.2
    th_fast_hi: int = 20  # iniThFAST (TUM1.yaml:58)
    th_fast_lo: int = 7  # minThFAST (TUM1.yaml:62)
    cell: int = 32  # spread-grid cell size on the canvas
    k_per_cell: int = 8

    @property
    def level_quota(self):
        """Per-level keypoint budget, geometric in 1/scale — mirrors
        mnFeaturesPerLevel (ORBextractor.cc:442-457)."""
        f = 1.0 / self.scale
        n_desired = self.n_features * (1 - f) / (1 - f**self.levels)
        quotas = [int(round(n_desired * f**l)) for l in range(self.levels)]
        quotas[-1] = max(self.n_features - sum(quotas[:-1]), 0)
        return quotas

    @property
    def capacity(self):
        return sum(self.level_quota)


from typing import NamedTuple  # noqa: E402


class OrbFeatures(NamedTuple):
    """SoA keypoint set (fixed capacity N = config.capacity)."""

    uv: jnp.ndarray  # (N, 2) level-0 pixel coords (x, y)
    uv_lvl: jnp.ndarray  # (N, 2) level-local coords on the canvas
    level: jnp.ndarray  # (N,) int32 octave
    response: jnp.ndarray  # (N,) float32
    angle: jnp.ndarray  # (N,) float32 radians
    desc: jnp.ndarray  # (N, 32) uint8 packed 256-bit descriptor
    valid: jnp.ndarray  # (N,) bool


# ---------------------------------------------------------------------------
# Orientation: circular-patch moments as convolutions
# ---------------------------------------------------------------------------


def _moment_kernels():
    r = HALF_PATCH
    ys, xs = np.mgrid[-r : r + 1, -r : r + 1]
    mask = (xs**2 + ys**2) <= r**2 + 1  # circular patch like IC_Angle's u_max
    kx = (xs * mask).astype(np.float32)
    ky = (ys * mask).astype(np.float32)
    return jnp.asarray(kx), jnp.asarray(ky)


PATCH = 32  # descriptor/moment patch side: the BRIEF pattern is clipped to
# a disk of radius 13 (so every rotation stays within +-14 px of center) and
# the IC-angle moment mask has radius 15 -> offsets [-15, +15] fit the
# [c-16, c+15] span of a 32-pixel patch with c = 16. Was 48; the patch
# extraction + selection matmul are the dominant frontend cost and scale
# with PATCH^2.


def extract_patches(stack, uv_lvl, level, size: int = PATCH):
    """(N, size, size) patches around keypoints.

    Row gather + one-hot column-select matmul: whole rows are gathered,
    then the per-keypoint column window is cut with an exact
    (HIGHEST-precision) one-hot contraction. Whether a direct gather is as
    fast on the GPU is open (ROADMAP design item 1).
    """
    L, h, w = stack.shape
    half = size // 2
    y0 = jnp.clip(uv_lvl[:, 1].astype(jnp.int32) - half, 0, h - size)
    x0 = jnp.clip(uv_lvl[:, 0].astype(jnp.int32) - half, 0, w - size)
    flat = stack.reshape(L * h, w)
    row_idx = (level * h + y0)[:, None] + jnp.arange(size)[None, :]
    rows = flat[row_idx]  # (N, size, w)
    col = x0[:, None, None] + jnp.arange(size)[None, None, :]
    onehot = (jnp.arange(w)[None, :, None] == col).astype(stack.dtype)
    # One nonzero per contraction row -> the "sum" is a single product of
    # the pixel value with 1.0: exact at any matmul input precision (incl.
    # bf16 stacks), so no HIGHEST-precision multi-pass is needed.
    precision = (
        jax.lax.Precision.DEFAULT
        if stack.dtype == jnp.bfloat16
        else jax.lax.Precision.HIGHEST
    )
    return jnp.einsum(
        "nrw,nwj->nrj",
        rows,
        onehot,
        preferred_element_type=jnp.float32,
        precision=precision,
    )


def keypoint_angles(patches):
    """IC angle from (N, P, P) patches: one moment matmul.

    Equivalent to IC_Angle's circular-patch moments, computed only at the
    keypoints instead of as a whole-image 31x31 single-channel conv.
    """
    n = patches.shape[0]
    size = patches.shape[-1]
    r = HALF_PATCH
    c = size // 2
    ys, xs = np.mgrid[0:size, 0:size]
    mask = ((xs - c) ** 2 + (ys - c) ** 2) <= r**2 + 1
    kx = ((xs - c) * mask).astype(np.float32).reshape(-1)
    ky = ((ys - c) * mask).astype(np.float32).reshape(-1)
    kmat = jnp.asarray(np.stack([kx, ky], axis=-1))  # (size^2, 2)
    m = jnp.dot(patches.reshape(n, -1), kmat, preferred_element_type=jnp.float32)
    return jnp.arctan2(m[:, 1], m[:, 0])


# ---------------------------------------------------------------------------
# Descriptor pattern
# ---------------------------------------------------------------------------


def _brief_pattern(n_bits: int = 256, seed: int = 1234):
    """(n_bits, 4) int32 [ax, ay, bx, by] Gaussian test pairs (BRIEF G-II).

    sigma = patch/5 per the BRIEF paper; clipped to stay inside the rotated
    patch radius.
    """
    rng = np.random.default_rng(seed)
    sigma = (2 * HALF_PATCH + 1) / 5.0
    pts = rng.normal(0.0, sigma, size=(n_bits, 4))
    # Clip each test point to a DISK of radius HALF_PATCH-2 (not a square):
    # a disk is rotation-invariant, so every rotated sample stays within
    # +-(HALF_PATCH-1) of center and the 32-pixel patch suffices.
    r_max = float(HALF_PATCH - 2)
    for cols in ((0, 1), (2, 3)):
        xy = pts[:, cols]
        r = np.linalg.norm(xy, axis=1, keepdims=True)
        pts[:, cols] = np.where(r > r_max, xy * (r_max / r), xy)
    return np.round(pts).astype(np.int32)  # host-side constant (numpy)


_PATTERN = _brief_pattern()

N_ANGLE_BINS = 32


def _bin_sample_indices():
    """(B, 512) int32: flattened 48x48 patch index of each rotated test point
    for each quantized angle bin (256 a-points then 256 b-points).

    Rotating the pattern per-bin turns descriptor sampling into a one-hot
    selection matmul instead of a per-element gather. Bin width
    2*pi/32 = 11.25 deg -> max 5.6 deg rotation error, within rBRIEF's
    tolerance (validated by the translation/rotation matching tests).
    """
    pat = np.asarray(_PATTERN, np.float64)  # (256, 4) [ax, ay, bx, by]
    pts = np.concatenate([pat[:, 0:2], pat[:, 2:4]], axis=0)  # (512, 2)
    half = PATCH // 2
    out = np.zeros((N_ANGLE_BINS, 512), np.int32)
    for b in range(N_ANGLE_BINS):
        th = 2.0 * np.pi * b / N_ANGLE_BINS
        ca, sa = np.cos(th), np.sin(th)
        rx = pts[:, 0] * ca - pts[:, 1] * sa
        ry = pts[:, 0] * sa + pts[:, 1] * ca
        xi = np.clip(np.round(rx).astype(np.int64) + half, 0, PATCH - 1)
        yi = np.clip(np.round(ry).astype(np.int64) + half, 0, PATCH - 1)
        out[b] = (yi * PATCH + xi).astype(np.int32)
    return out


def _selection_matrix():
    """(PATCH^2, B*512) bf16 constant: one-hot columns selecting, for each
    angle bin, the 512 rotated test-point pixels of a 48x48 patch."""
    idx = _bin_sample_indices()  # (B, 512) numpy
    npx = PATCH * PATCH
    S = np.zeros((npx, N_ANGLE_BINS * 512), np.float32)
    cols = np.arange(N_ANGLE_BINS * 512)
    S[idx.reshape(-1), cols] = 1.0
    return jnp.asarray(S, jnp.bfloat16)


_SEL = None


def _brief_bits(bpatch, angle):
    """(N, 48, 48) blurred patches + (N,) angles -> (N, 256) uint8 bits.

    Sampling at all 32 bin rotations is ONE (N, 2304) x (2304, 32*512) bf16
    matmul against a constant one-hot selection matrix; the per-keypoint
    bin is then combined with a mask-weighted sum.
    """
    global _SEL
    if _SEL is None:
        # Force eager evaluation: without it a first call under jit would
        # cache a tracer from that trace and poison every later retrace.
        with jax.ensure_compile_time_eval():
            _SEL = _selection_matrix()
    n = bpatch.shape[0]
    flat = bpatch.reshape(n, -1).astype(jnp.bfloat16)
    two_pi = 2.0 * jnp.pi
    bin_f = (angle % two_pi) * (N_ANGLE_BINS / two_pi)
    kp_bin = jnp.round(bin_f).astype(jnp.int32) % N_ANGLE_BINS
    sampled = jax.lax.dot_general(
        flat, _SEL, (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32
    ).reshape(n, N_ANGLE_BINS, 512)
    onehot = (kp_bin[:, None] == jnp.arange(N_ANGLE_BINS)[None, :]).astype(
        jnp.float32
    )
    acc = jnp.einsum("nbs,nb->ns", sampled, onehot)
    return (acc[:, :256] < acc[:, 256:]).astype(jnp.uint8)


# ---------------------------------------------------------------------------
# Extraction
# ---------------------------------------------------------------------------


def _per_level_mask(shape, levels, scale, h, w):
    """Detection-valid mask per level: inside the level extent minus EDGE."""
    masks = []
    ys, xs = np.mgrid[0:h, 0:w]
    for l in range(levels):
        s = 1.0 / scale**l
        hl, wl = int(round(h * s)), int(round(w * s))
        m = (
            (xs >= EDGE)
            & (xs < wl - EDGE)
            & (ys >= EDGE)
            & (ys < hl - EDGE)
        )
        masks.append(m)
    return jnp.asarray(np.stack(masks))


@partial(jax.jit, static_argnames=("cfg", "h", "w"))
def detect_keypoints(stack, cfg: OrbConfig, h: int, w: int):
    """FAST + per-cell fallback + spread top-k selection on a level stack.

    Returns (uv_lvl (N, 2) canvas coords, level (N,), response (N,)).
    Mirrors ComputeKeyPointsOctTree + DistributeOctTree semantics
    (ORBextractor.cc:765-853, 539-763) as masked reductions.
    """
    L = cfg.levels
    det_mask = _per_level_mask((h, w), L, cfg.scale, h, w)

    # --- FAST at both thresholds (one pass), with per-cell fallback -------
    hi_corner, lo_corner, score_lo = fast_score_dual(
        stack, cfg.th_fast_hi, cfg.th_fast_lo
    )
    keep_nms = nms3x3(jnp.where(lo_corner & det_mask, score_lo, 0.0))

    cs = cfg.cell
    ncy, ncx = h // cs, w // cs
    hc, wc = ncy * cs, ncx * cs  # crop ragged edge of the cell grid

    def to_cells(x):
        """(L, H, W) -> (L, ncy, ncx, cs*cs)."""
        return (
            x[:, :hc, :wc]
            .reshape(L, ncy, cs, ncx, cs)
            .transpose(0, 1, 3, 2, 4)
            .reshape(L, ncy, ncx, cs * cs)
        )

    # Threshold fallback entirely in cell space (no full-canvas expands):
    # where a cell has any high-threshold corner, only those count;
    # otherwise the low-threshold corners do (ORBextractor.cc:800-816).
    cand = to_cells(keep_nms & lo_corner & det_mask)
    hi_c = to_cells(hi_corner & det_mask) & cand
    has_hi = hi_c.any(axis=-1, keepdims=True)
    allowed = jnp.where(has_hi, hi_c, cand)
    cell_scores = jnp.where(allowed, to_cells(score_lo), 0.0)

    # --- spatial spread: top-k per cell, then top-quota per level ---------
    # Both stages use approx_max_k (exact top-k off the platforms with an
    # approximate kernel); a ~2% recall loss on a response-ranked spread
    # heuristic is behaviorally irrelevant (the reference's quadtree is
    # itself only a spreading heuristic, ORBextractor.cc:539).
    k = cfg.k_per_cell
    top_v, top_i = jax.lax.approx_max_k(cell_scores, k)  # (L, ncy, ncx, k)
    iy = top_i // cs
    ix = top_i % cs
    cy = jnp.arange(ncy)[None, :, None, None]
    cx = jnp.arange(ncx)[None, None, :, None]
    ys = (cy * cs + iy).reshape(L, -1)
    xs = (cx * cs + ix).reshape(L, -1)
    vs = top_v.reshape(L, -1)

    quotas = cfg.level_quota
    uv_lvl, level_arr, resp = [], [], []
    for l in range(L):
        q = quotas[l]
        v_l, idx = jax.lax.approx_max_k(vs[l], q)
        uv_lvl.append(jnp.stack([xs[l][idx], ys[l][idx]], axis=-1))
        level_arr.append(jnp.full((q,), l, jnp.int32))
        resp.append(v_l)
    uv_lvl = jnp.concatenate(uv_lvl).astype(jnp.float32)  # (N, 2) canvas coords
    level = jnp.concatenate(level_arr)
    response = jnp.concatenate(resp).astype(jnp.float32)
    return uv_lvl, level, response


@partial(jax.jit, static_argnames=("cfg",))
def extract_orb(img, cfg: OrbConfig = OrbConfig()) -> OrbFeatures:
    """img: (H, W) float32 grayscale in [0, 255] -> OrbFeatures."""
    h, w = img.shape
    L = cfg.levels
    stack, level_scale, _ = build_pyramid(img, L, cfg.scale)
    # Materialize the pyramid: without the barrier XLA may fuse the whole
    # resize chain into every downstream gather and recompute it per
    # sample.
    stack = jax.lax.optimization_barrier(stack)
    # The DETECTION half (FAST, NMS, cell top-k) is HBM-bound on (L, H, W)
    # canvases; bf16 halves that traffic. Corner decisions are threshold
    # comparisons and scores only rank (see fast_score_dual's flip-rate
    # note). The DESCRIPTOR half (blur, patches, BRIEF bits) stays f32:
    # bf16 blur accumulation measurably degrades descriptor
    # distinctiveness, which the large-motion unwindowed fallback
    # (track_ops.track_against_points_unwindowed) depends on.
    uv_lvl, level, response = detect_keypoints(
        stack.astype(jnp.bfloat16), cfg, h, w
    )
    valid = response > 0.0

    # --- orientation + descriptors from ONE patch extraction --------------
    # The reference computes IC angle on the raw image and descriptors on
    # the blurred one (ORBextractor.cc:1034-1066); a Gaussian blur is
    # rotationally symmetric, so computing BOTH from the blurred patch
    # changes the angle estimate negligibly and halves the patch-gather
    # cost.
    uv_lvl, level, response = jax.lax.optimization_barrier(
        (uv_lvl, level, response)
    )
    # Barrier: without it the blur fuses into the 1k patch slices and gets
    # recomputed per patch.
    blurred = jax.lax.optimization_barrier(gaussian_blur(stack))
    bpatch = extract_patches(blurred, uv_lvl, level)  # (N, 48, 48)
    angle = keypoint_angles(bpatch)
    bits = _brief_bits(bpatch, angle)
    weights = jnp.asarray([1, 2, 4, 8, 16, 32, 64, 128], jnp.uint8)
    desc = jnp.sum(
        bits.reshape(-1, 32, 8) * weights[None, None, :], axis=-1, dtype=jnp.uint8
    )

    # --- level-0 coordinates & output ------------------------------------
    uv0 = uv_lvl * level_scale[level][:, None]
    return OrbFeatures(
        uv=uv0,
        uv_lvl=uv_lvl,
        level=level,
        response=response,
        angle=angle,
        desc=desc,
        valid=valid,
    )


def scale_sigma2(cfg: OrbConfig):
    """Per-level sigma^2 (reference mvLevelSigma2, Frame.cc ctor)."""
    return jnp.asarray(
        [(cfg.scale**l) ** 2 for l in range(cfg.levels)], jnp.float32
    )
