"""Line band descriptors (LBD-style) as one batched sampling + reduction.

Replaces the reference's BinaryDescriptor
(Thirdparty/line_descriptor/src/binary_descriptor_custom.cpp, used via
LINEextractor::operator(), add_src/LineExtractor.cpp:348-350): the line
support region is split into bands parallel to the line; each band is
described by mean/std statistics of the image gradient expressed in the line
frame (d_parallel, d_perpendicular).

Deviations from the reference:
- the descriptor stays *float* (unit-normalized, matched as a squared-L2
  matrix via one matmul) instead of LBD's 256-bit binarization +
  popcount — on an accelerator a float dot is the cheap primitive, and matching is
  internal to this framework so only self-consistency matters;
- sampling is a fixed (S along x C across) grid per line scaled to the
  segment length, making every line's descriptor one fused gather+reduce
  with static shapes (the reference walks pixel rows per band).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from pslam.ops.lines import image_gradients

S_ALONG = 16  # samples along the line
N_BANDS = 5
BAND_PX = 3  # band width in px
C_ACROSS = N_BANDS * BAND_PX  # perpendicular samples
DESC_DIM = N_BANDS * 8  # mean(4) + std(4) per band


def _across_weights():
    """Global Gaussian over the across-line offset (LBD's f_g)."""
    off = np.arange(C_ACROSS) - (C_ACROSS - 1) / 2.0
    sigma = C_ACROSS / 2.0
    w = np.exp(-0.5 * (off / sigma) ** 2)
    return jnp.asarray(w / w.sum(), jnp.float32), jnp.asarray(off, jnp.float32)


@partial(jax.jit, static_argnames=())
def line_descriptors(img, sp, ep, valid):
    """img (H, W) float32; sp/ep (NL, 2); valid (NL,) -> (NL, DESC_DIM).

    Invalid lines get zero descriptors.
    """
    h, w = img.shape
    gx, gy = image_gradients(img)

    d = ep - sp
    length = jnp.maximum(jnp.linalg.norm(d, axis=-1), 1e-9)
    dirs = d / length[:, None]  # (NL, 2) along
    nrm = jnp.stack([-dirs[:, 1], dirs[:, 0]], axis=-1)  # perpendicular

    w_g, off = _across_weights()
    t = jnp.linspace(0.0, 1.0, S_ALONG)  # (S,)
    base = sp[:, None, :] + t[None, :, None] * d[:, None, :]  # (NL, S, 2)
    pts = (
        base[:, :, None, :] + off[None, None, :, None] * nrm[:, None, None, :]
    )  # (NL, S, C, 2)

    xi = jnp.clip(jnp.round(pts[..., 0]).astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(jnp.round(pts[..., 1]).astype(jnp.int32), 0, h - 1)
    gxs = gx[yi, xi]  # (NL, S, C)
    gys = gy[yi, xi]

    g_par = gxs * dirs[:, None, None, 0] + gys * dirs[:, None, None, 1]
    g_per = gxs * nrm[:, None, None, 0] + gys * nrm[:, None, None, 1]

    # 4 half-wave channels per sample (LBD's banded gradient statistics).
    feats = jnp.stack(
        [
            jnp.maximum(g_per, 0.0),
            jnp.maximum(-g_per, 0.0),
            jnp.maximum(g_par, 0.0),
            jnp.maximum(-g_par, 0.0),
        ],
        axis=-1,
    )  # (NL, S, C, 4)
    feats = feats * w_g[None, None, :, None]

    # Band partition along the across axis.
    bands = feats.reshape(feats.shape[0], S_ALONG, N_BANDS, BAND_PX, 4)
    col = jnp.sum(bands, axis=3)  # (NL, S, B, 4): per-column band vector

    mean = jnp.mean(col, axis=1)  # (NL, B, 4)
    std = jnp.std(col, axis=1)  # (NL, B, 4)
    desc = jnp.concatenate([mean, std], axis=-1).reshape(-1, DESC_DIM)

    # Unit-normalize (brightness/contrast invariance), clip spikes like LBD.
    desc = desc / jnp.maximum(jnp.linalg.norm(desc, axis=-1, keepdims=True), 1e-9)
    desc = jnp.clip(desc, 0.0, 0.4)
    desc = desc / jnp.maximum(jnp.linalg.norm(desc, axis=-1, keepdims=True), 1e-9)
    return jnp.where(valid[:, None], desc, 0.0)


def line_dist_matrix(desc_a, desc_b):
    """(Na, D) x (Nb, D) unit descriptors -> (Na, Nb) squared L2 in [0, 4].

    One matmul: ||a-b||^2 = 2 - 2 a.b for unit vectors.
    """
    dot = jax.lax.dot_general(
        desc_a, desc_b,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    return jnp.maximum(2.0 - 2.0 * dot, 0.0)
