"""Projection matching: the plain path (ops/match.py: window_mask +
level_window_mask + hamming_matrix + mutual_nn_match) against a numpy
brute-force loop over candidate pairs."""

import jax.numpy as jnp
import numpy as np
import pytest

from pslam.ops.match import (
    hamming_matrix,
    level_window_mask,
    mutual_nn_match,
    window_mask,
)

CASES = [(200, 300, 0), (128, 128, 1), (50, 700, 2)]


def planted_problem(na, nb, seed):
    """Random descriptors with half of A planted (one bit flipped) in B,
    inside the geometric and octave windows so real matches exist."""
    rng = np.random.default_rng(seed)
    desc_a = rng.integers(0, 256, (na, 32), dtype=np.uint8)
    desc_b = rng.integers(0, 256, (nb, 32), dtype=np.uint8)
    plant = rng.permutation(min(na, nb))[: min(na, nb) // 2]
    for i, j in enumerate(plant):
        desc_b[j] = desc_a[i]
        flip = rng.integers(0, 32)
        desc_b[j, flip] ^= np.uint8(1 << rng.integers(0, 8))

    uv_a = rng.uniform(0, 640, (na, 2)).astype(np.float32)
    uv_b = uv_a[rng.integers(0, na, nb)] + rng.normal(0, 6, (nb, 2)).astype(
        np.float32
    )
    lev_a = rng.integers(0, 8, na).astype(np.int32)
    lev_b = rng.integers(0, 8, nb).astype(np.int32)
    for i, j in enumerate(plant):
        uv_b[j] = uv_a[i] + rng.normal(0, 2, 2).astype(np.float32)
        lev_b[j] = lev_a[i]
    val_a = rng.uniform(size=na) > 0.1
    val_b = rng.uniform(size=nb) > 0.1
    radius = rng.uniform(5, 25, na).astype(np.float32)
    return desc_a, desc_b, uv_a, uv_b, lev_a, lev_b, val_a, val_b, radius


def plain_match(desc_a, desc_b, uv_a, uv_b, lev_a, lev_b, val_a, val_b,
                radius):
    box = window_mask(jnp.asarray(uv_a), jnp.asarray(uv_b), jnp.asarray(radius))
    lvl = level_window_mask(jnp.asarray(lev_a), jnp.asarray(lev_b), -1, 1)
    dist = hamming_matrix(jnp.asarray(desc_a), jnp.asarray(desc_b))
    idx, d = mutual_nn_match(
        dist, valid_a=jnp.asarray(val_a), valid_b=jnp.asarray(val_b),
        max_dist=100, ratio=0.9, extra_mask=box & lvl,
    )
    return np.asarray(idx), np.asarray(d)


def brute_force_match(desc_a, desc_b, uv_a, uv_b, lev_a, lev_b, val_a, val_b,
                      radius, max_dist=100, ratio=0.9):
    """One candidate pair at a time, as the reference's search loops."""
    na, nb = len(desc_a), len(desc_b)
    bits_a = np.unpackbits(desc_a, axis=1)
    bits_b = np.unpackbits(desc_b, axis=1)
    d = np.full((na, nb), 1 << 20, np.int64)
    for i in range(na):
        for j in range(nb):
            if (
                val_a[i] and val_b[j]
                and abs(uv_a[i, 0] - uv_b[j, 0]) <= radius[i]
                and abs(uv_a[i, 1] - uv_b[j, 1]) <= radius[i]
                and lev_a[i] - 1 <= lev_b[j] <= lev_a[i] + 1
            ):
                d[i, j] = np.count_nonzero(bits_a[i] != bits_b[j])
    idx = np.full(na, -1)
    for i in range(na):
        j, j2 = np.argsort(d[i], kind="stable")[:2]
        mutual = np.argmin(d[:, j]) == i
        if d[i, j] <= max_dist and d[i, j] < ratio * d[i, j2] and mutual:
            idx[i] = j
    return idx


@pytest.mark.parametrize("na,nb,seed", CASES)
def test_plain_matches_brute_force(na, nb, seed):
    prob = planted_problem(na, nb, seed)
    idx, _ = plain_match(*prob)
    np.testing.assert_array_equal(idx, brute_force_match(*prob))
    assert (idx >= 0).sum() > 0  # planted matches must actually survive
