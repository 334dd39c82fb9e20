"""FAST-16 corner response, fully vectorized over a level stack.

Replaces the per-cell cv::FAST calls of ORBextractor::ComputeKeyPointsOctTree
(reference src/ORBextractor.cc:765-853). Instead of looping 35px cells with a
threshold fallback, we compute the segment-test mask and a contrast score for
*every* pixel of every level in one shot (16 shifted comparisons),
at both the high and low thresholds; the caller then applies the
grid/fallback/top-k selection as masked reductions.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# Bresenham circle of radius 3: 16 (dx, dy) offsets in cyclic (clockwise)
# order starting at 12 o'clock — the standard FAST-16 test geometry.
CIRCLE = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    dtype=np.int32,
)
ARC_LEN = 9  # FAST-9/16 contiguous arc requirement (cv::FastFeatureDetector)


def _shift2d(img, dy: int, dx: int):
    """Shift (..., H, W) by (dy, dx) with zero fill (borders masked later)."""
    return jnp.roll(img, shift=(-dy, -dx), axis=(-2, -1))


def _has_arc9(mask16):
    """(16, ...) bool ring mask -> True where a contiguous arc of >= 9
    circle pixels is set. Packs the ring into an int32 bitmask and uses
    log-step shift-ANDs (runs>=2 -> >=4 -> >=8 -> >=9): ~10 int ops instead
    of the naive 16 rotations x 8 ANDs."""
    w = jnp.asarray(
        np.asarray([1 << s for s in range(16)], np.int32), jnp.int32
    ).reshape((16,) + (1,) * (mask16.ndim - 1))
    m = jnp.sum(mask16.astype(jnp.int32) * w, axis=0)
    mm = m | (m << 16)  # unwrap the cycle
    r = mm & (mm >> 1)
    r = r & (r >> 2)
    r = r & (r >> 4)  # runs >= 8
    r = r & (mm >> 8)  # runs >= 9
    return (r & 0xFFFF) != 0


def _arc9_from_bits(m):
    """int32 16-bit ring mask -> True where a contiguous arc of >= 9 is set."""
    mm = m | (m << 16)  # unwrap the cycle
    r = mm & (mm >> 1)
    r = r & (r >> 2)
    r = r & (r >> 4)  # runs >= 8
    r = r & (mm >> 8)  # runs >= 9
    return (r & 0xFFFF) != 0


@partial(jax.jit, static_argnames=("th_hi", "th_lo"))
def fast_score_dual(stack, th_hi: int, th_lo: int):
    """One-pass FAST at BOTH thresholds + the low-threshold ranking score.

    Returns (corner_hi, corner_lo, score_lo). The 16 circle comparisons are
    accumulated into int32 bitmasks and running score sums one offset at a
    time — nothing with a leading 16-axis is ever materialized (the r3
    version stacked (16, L, H, W) diffs/bools: ~600 MB of HBM traffic per
    frame; this form is ~10 arrays of (L, H, W)). The pass is HBM-bound, so
    it runs in bfloat16. Level-0 pixels are integers <= 255 whose
    differences are exact in bf16; HIGHER pyramid levels are resampled/
    blurred floats, where the bf16 cast (~2^-8 relative rounding) can flip
    a comparison whose |diff| sits within rounding distance of the
    threshold — the measured flip rate on interpolated levels is a small
    fraction of a percent of corner decisions
    (tests/test_round5.py::test_fast_bf16_flip_rate), which the downstream
    top-k ranking and matching absorb.
    """
    out_dtype = stack.dtype
    stack = stack.astype(jnp.bfloat16)
    center = stack
    t_lo = jnp.asarray(th_lo, stack.dtype)
    t_hi = jnp.asarray(th_hi, stack.dtype)

    zero_i = jnp.zeros(stack.shape, jnp.int32)
    zero_f = jnp.zeros(stack.shape, stack.dtype)
    m_hi_b = m_hi_d = m_lo_b = m_lo_d = zero_i
    score_b = score_d = zero_f
    for s, (dx, dy) in enumerate(CIRCLE):
        diff = _shift2d(stack, int(dy), int(dx)) - center
        bit = jnp.int32(1 << s)
        b_lo = diff > t_lo
        d_lo = diff < -t_lo
        m_lo_b = m_lo_b | jnp.where(b_lo, bit, 0)
        m_lo_d = m_lo_d | jnp.where(d_lo, bit, 0)
        m_hi_b = m_hi_b | jnp.where(diff > t_hi, bit, 0)
        m_hi_d = m_hi_d | jnp.where(diff < -t_hi, bit, 0)
        excess = jnp.abs(diff) - t_lo
        score_b = score_b + jnp.where(b_lo, excess, 0.0)
        score_d = score_d + jnp.where(d_lo, excess, 0.0)

    corner_hi = _arc9_from_bits(m_hi_b) | _arc9_from_bits(m_hi_d)
    corner_lo = _arc9_from_bits(m_lo_b) | _arc9_from_bits(m_lo_d)
    score_lo = jnp.maximum(score_b, score_d).astype(out_dtype)
    return corner_hi, corner_lo, score_lo


@partial(jax.jit, static_argnames=("threshold",))
def fast_score(stack, threshold: int):
    """Segment test + score for each pixel.

    stack: (..., H, W) float32 intensities.
    Returns (is_corner (..., H, W) bool, score (..., H, W) float32) where
    score is the sum of |I_p - I_center| over circle pixels on the dominant
    (brighter/darker) arc side — the same ranking statistic cv::FAST uses.
    Border pixels (3px) are NOT masked here.
    """
    center = stack
    t = jnp.asarray(threshold, stack.dtype)

    neigh = jnp.stack(
        [_shift2d(stack, int(dy), int(dx)) for (dx, dy) in CIRCLE], axis=0
    )  # (16, ..., H, W)
    diff = neigh - center[None]
    brighter = diff > t
    darker = diff < -t

    def has_arc(mask):
        # Contiguous run of ARC_LEN around the 16-cycle: OR over the 16
        # rotations of an AND over ARC_LEN consecutive elements.
        out = jnp.zeros_like(mask[0])
        for s in range(16):
            run = mask[s]
            for i in range(1, ARC_LEN):
                run = run & mask[(s + i) % 16]
            out = out | run
        return out

    is_corner = has_arc(brighter) | has_arc(darker)

    excess = jnp.abs(diff) - t
    score_b = jnp.sum(jnp.where(brighter, excess, 0.0), axis=0)
    score_d = jnp.sum(jnp.where(darker, excess, 0.0), axis=0)
    score = jnp.maximum(score_b, score_d)
    return is_corner, score


def nms3x3(score):
    """3x3 non-maximum suppression mask for (..., H, W) scores (one fused
    reduce_window instead of 8 materialized shifted copies)."""
    neigh_max = jax.lax.reduce_window(
        score,
        -jnp.inf,
        jax.lax.max,
        window_dimensions=(1,) * (score.ndim - 2) + (3, 3),
        window_strides=(1,) * score.ndim,
        padding="SAME",
    )
    return score >= neigh_max
