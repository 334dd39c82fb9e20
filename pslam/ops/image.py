"""Image pyramid and blur ops.

Replaces ORBextractor::ComputePyramid (reference src/ORBextractor.cc:1107)
with a padded level *stack*: all levels live on one (L, H, W) canvas so the
whole frontend runs as a single static-shape batched program — the
accelerator-idiomatic alternative to per-level OpenCV calls. Invalid canvas area is
masked, not branched over.
"""

from __future__ import annotations

import functools
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

PYR_LEVELS = 8
PYR_SCALE = 1.2  # reference ORBextractor.scaleFactor (TUM1.yaml:49)


def level_shapes(h: int, w: int, levels: int = PYR_LEVELS, scale: float = PYR_SCALE):
    """Concrete (h_l, w_l) per level, matching cv::resize round()."""
    out = []
    for l in range(levels):
        s = 1.0 / scale**l
        out.append((int(round(h * s)), int(round(w * s))))
    return out


def _resize_matrix_1d(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bilinear interpolation matrix matching
    jax.image.resize(..., 'bilinear') (half-pixel centers, edge clamp)."""
    out = np.zeros((n_out, n_in), np.float32)
    scale = n_in / n_out
    for i in range(n_out):
        x = (i + 0.5) * scale - 0.5
        x0 = int(np.floor(x))
        f = x - x0
        a = min(max(x0, 0), n_in - 1)
        b = min(max(x0 + 1, 0), n_in - 1)
        out[i, a] += 1.0 - f
        out[i, b] += f
    return out


@functools.lru_cache(maxsize=8)
def _pyramid_matrices(h: int, w: int, levels: int, scale: float):
    """Composed per-level (row, col) interpolation matrices replicating the
    reference's SUCCESSIVE level-from-previous-level resizes
    (ORBextractor.cc:1107-1129): bilinear resampling is linear, so the chain
    of per-step matrices composes into one (h_l, H) / (w_l, W) matrix per
    level — the whole pyramid is then 2 matmuls per level instead of a
    serial gather-based resize chain."""
    shapes = level_shapes(h, w, levels, scale)
    Rs, Cs = [], []
    R = np.eye(h, dtype=np.float32)
    C = np.eye(w, dtype=np.float32)
    prev = (h, w)
    for l, (hl, wl) in enumerate(shapes):
        if l > 0:
            R = _resize_matrix_1d(prev[0], hl) @ R
            C = _resize_matrix_1d(prev[1], wl) @ C
        prev = (hl, wl)
        # Pad to canvas size so every level is one (H, H) x (H, W) x (W, W).
        Rp = np.zeros((h, h), np.float32)
        Rp[:hl] = R
        Cp = np.zeros((w, w), np.float32)
        Cp[:wl] = C
        Rs.append(Rp)
        Cs.append(Cp)
    return np.stack(Rs), np.stack(Cs)


def build_pyramid(img, levels: int = PYR_LEVELS, scale: float = PYR_SCALE):
    """img (H, W) float32 -> (stack (L, H, W), level_scale (L,), valid (L, H, W)).

    Level l contains the bilinear-downsampled image in its top-left
    (h_l, w_l) corner; the rest of the canvas is zero and masked. Resampling
    runs as batched constant-matrix matmuls (see _pyramid_matrices)."""
    h, w = img.shape
    with jax.ensure_compile_time_eval():
        R_np, C_np = _pyramid_matrices(h, w, levels, scale)
        R = jnp.asarray(R_np)
        C = jnp.asarray(C_np)
        shapes = level_shapes(h, w, levels, scale)
        masks = np.zeros((levels, h, w), bool)
        for l, (hl, wl) in enumerate(shapes):
            masks[l, :hl, :wl] = True
        valid = jnp.asarray(masks)
    # Explicit HIGHEST so the exact-f32 resample survives import paths that
    # bypass pslam/__init__.py's global jax_default_matmul_precision
    # override (a reduced-precision f32 product — TF32 on the GPU — would
    # make the pyramid, and every descriptor downstream, diverge from the
    # CPU-exact result).
    stack = jnp.einsum(
        "lyh,hw,lxw->lyx", R, img, C, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    level_scale = jnp.asarray([scale**l for l in range(levels)], img.dtype)
    return stack, level_scale, valid


def _gaussian_kernel1d(ksize: int, sigma: float):
    x = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


@partial(jax.jit, static_argnames=("ksize", "sigma"))
def gaussian_blur(stack, ksize: int = 7, sigma: float = 2.0):
    """Separable Gaussian blur on a level stack (L, H, W) (or (H, W)).

    Matches the GaussianBlur(7, 7, 2, 2, BORDER_REFLECT_101) applied before
    descriptor sampling (ORBextractor.cc:1063-1066). Implemented as
    shift-and-add over static slices of a reflect-padded canvas: a 7-tap
    1-channel conv has no channel contraction, and 14 weighted adds fuse
    into one elementwise pass.
    """
    squeeze = stack.ndim == 2
    if squeeze:
        stack = stack[None]
    k = np.asarray(_gaussian_kernel1d(ksize, sigma))
    pad = ksize // 2
    L, H, W = stack.shape
    x = jnp.pad(stack, ((0, 0), (pad, pad), (0, 0)), mode="reflect")
    x = sum(
        float(k[i]) * jax.lax.slice(x, (0, i, 0), (L, i + H, W))
        for i in range(ksize)
    )
    x = jnp.pad(x, ((0, 0), (0, 0), (pad, pad)), mode="reflect")
    x = sum(
        float(k[i]) * jax.lax.slice(x, (0, 0, i), (L, H, i + W))
        for i in range(ksize)
    )
    return x[0] if squeeze else x


def sample_nearest(stack, lvl_idx, y, x):
    """Nearest-neighbour gather from a level stack.

    stack (L, H, W); lvl_idx/y/x broadcastable int/float arrays. Coordinates
    are clamped to the canvas.
    """
    h, w = stack.shape[-2:]
    yi = jnp.clip(jnp.round(y).astype(jnp.int32), 0, h - 1)
    xi = jnp.clip(jnp.round(x).astype(jnp.int32), 0, w - 1)
    return stack[lvl_idx, yi, xi]


def gather_pixels_matmul(img, y, x):
    """Gather img[y_i, x_i] for (N,) index vectors via two one-hot
    contractions: the one-hot row-select matmul (N, H) x (H, W) followed by
    a masked row reduction. Whether a plain gather is as fast on the GPU
    is open (ROADMAP design item 1).
    """
    h, w = img.shape
    yi = jnp.clip(jnp.round(y).astype(jnp.int32), 0, h - 1)
    xi = jnp.clip(jnp.round(x).astype(jnp.int32), 0, w - 1)
    row_sel = (yi[:, None] == jnp.arange(h)[None, :]).astype(img.dtype)
    rows = jax.lax.dot_general(
        row_sel, img, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )  # (N, W)
    col_mask = xi[:, None] == jnp.arange(w)[None, :]
    return jnp.sum(jnp.where(col_mask, rows, 0.0), axis=1)
