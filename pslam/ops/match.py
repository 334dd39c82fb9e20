"""Descriptor matching as masked distance matrices.

Replaces the grid-search + per-candidate Hamming loops of ORBmatcher
(reference src/ORBmatcher.cc) with full N x M distance matrices: the
reference needs its 64x48 feature grid (Frame::GetFeaturesInArea) because a
CPU can't afford brute force; on an accelerator a masked 1k x 1k int matmul
is cheap, so *all* search modes (projection window, BoW bucket, epipolar
band) become masks over one matrix.

Hamming distance via the +/-1 trick: for descriptors unpacked to {-1, +1}
int8, dot(a, b) = n_bits - 2 * hamming  =>  hamming = (n_bits - dot) / 2.
The matmul runs in int8 with int32 accumulation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

N_BITS = 256
# Reference match gates (ORBmatcher.cc:37-38).
TH_HIGH = 100
TH_LOW = 50
HISTO_BINS = 30  # rotation-consistency histogram (ORBmatcher.cc:39)


def unpack_bits(desc_u8):
    """(N, 32) uint8 -> (N, 256) int8 in {-1, +1} (bit order LSB-first)."""
    bits = jnp.unpackbits(desc_u8, axis=-1, bitorder="little")
    return (bits.astype(jnp.int8) * 2 - 1)


def hamming_matrix(desc_a, desc_b):
    """(Na, 32) x (Nb, 32) packed uint8 -> (Na, Nb) int32 Hamming distances."""
    a = unpack_bits(desc_a)
    b = unpack_bits(desc_b)
    # Materialize the unpacked operands: when the descriptors are produced
    # upstream in the same program, XLA may fuse the whole extraction chain
    # into the matmul tiles and recompute it per tile.
    a, b = jax.lax.optimization_barrier((a, b))
    dot = jax.lax.dot_general(
        a,
        b,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return (N_BITS - dot) // 2


def rotation_consistency_mask(angle_a, angle_b, pair_mask):
    """Keep only matches in the 3 dominant rotation-difference bins.

    Mirrors ORBmatcher's rotation histogram check (ComputeThreeMaxima,
    ORBmatcher.cc:1601-1643): build a 30-bin histogram of angle differences
    over accepted pairs, keep pairs falling in the top-3 bins (bins with
    count < 0.1 * max are dropped like the reference).

    angle_a/angle_b: per-pair angles (radians), pair_mask: (N,) bool.
    Returns a refined (N,) bool mask.
    """
    diff = (angle_a - angle_b) % (2.0 * jnp.pi)
    bin_idx = jnp.clip(
        (diff * (HISTO_BINS / (2.0 * jnp.pi))).astype(jnp.int32), 0, HISTO_BINS - 1
    )
    hist = jnp.zeros(HISTO_BINS, jnp.int32).at[bin_idx].add(pair_mask.astype(jnp.int32))
    top3_v, top3_i = jax.lax.top_k(hist, 3)
    # Drop 2nd/3rd maxima below 10% of the max (ORBmatcher.cc:1634-1641).
    keep_bin = jnp.zeros(HISTO_BINS, bool)
    for j in range(3):
        ok = top3_v[j] >= jnp.maximum((0.1 * top3_v[0]).astype(jnp.int32), 1)
        keep_bin = keep_bin | (jnp.arange(HISTO_BINS) == top3_i[j]) & ok
    return pair_mask & keep_bin[bin_idx]


def mutual_nn_match(
    dist,
    valid_a=None,
    valid_b=None,
    max_dist: int = TH_LOW,
    ratio: float = 0.9,
    extra_mask=None,
):
    """Mutual nearest-neighbour matching with Lowe ratio on a distance matrix.

    dist: (Na, Nb) int32. Returns (match_idx (Na,) int32 = column or -1,
    match_dist (Na,) int32). Mirrors LSDmatcher::matchNNR / ORBmatcher BoW
    matching semantics (best, second-best, ratio, mutual check).
    """
    BIG = jnp.asarray(1 << 20, dist.dtype)
    d = dist
    if extra_mask is not None:
        d = jnp.where(extra_mask, d, BIG)
    if valid_a is not None:
        d = jnp.where(valid_a[:, None], d, BIG)
    if valid_b is not None:
        d = jnp.where(valid_b[None, :], d, BIG)

    # Best and second-best along rows.
    neg = -d
    top2_v, top2_i = jax.lax.top_k(neg, 2)
    best = -top2_v[:, 0]
    second = -top2_v[:, 1]
    best_j = top2_i[:, 0]

    # Mutual: column argmin must point back.
    col_best_i = jnp.argmin(d, axis=0)  # (Nb,)
    mutual = col_best_i[best_j] == jnp.arange(d.shape[0])

    ok = (
        (best <= max_dist)
        & (best.astype(jnp.float32) < ratio * second.astype(jnp.float32))
        & mutual
    )
    return jnp.where(ok, best_j, -1), best


def window_mask(uv_a, uv_b, radius):
    """(Na, 2) x (Nb, 2) -> (Na, Nb) bool: |du|,|dv| within radius.

    The replacement for Frame::GetFeaturesInArea grid queries: a
    projection search window becomes a pairwise box mask.
    radius: scalar or (Na,) per-query radius.
    """
    du = jnp.abs(uv_a[:, None, 0] - uv_b[None, :, 0])
    dv = jnp.abs(uv_a[:, None, 1] - uv_b[None, :, 1])
    r = jnp.asarray(radius)
    if r.ndim == 1:
        r = r[:, None]
    return (du <= r) & (dv <= r)


def level_window_mask(level_a, level_b, lo_off: int, hi_off: int):
    """Octave compatibility mask: level_b in [level_a+lo_off, level_a+hi_off]
    (reference SearchByProjection checks nPredictedLevel windows)."""
    lb = level_b[None, :]
    la = level_a[:, None]
    return (lb >= la + lo_off) & (lb <= la + hi_off)
