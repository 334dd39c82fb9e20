"""Line matching as masked distance matrices.

Replaces LSDmatcher (reference add_src/LSDmatcher.cpp) the same way
ops/match.py replaces ORBmatcher: every search mode is a mask over one
(Na, Nb) descriptor-distance matrix.

- ``match_lines_f2f``: SearchByGeomNApearance (LSDmatcher.cpp:36-110) —
  mutual-NN descriptor matching (match/matchNNR :354-413) + direction gate
  (|cos| >= cos 20 deg) + endpoint-shift gate (10% of image size on either
  endpoint).
- ``match_lines_projection``: SearchByProjection for map lines
  (LSDmatcher.cpp:112-258): project the 3D endpoints with a pose prior,
  gate by endpoint distance to the candidate segment, direction angle
  (10 deg), length ratio >= 0.75, descriptor distance.

Descriptor distances are float squared-L2 (see ops/lbd.py); the gates that
the reference expresses as Hamming thresholds (TH 80/95, LSDmatcher.cpp:12)
become DESC_TH on the [0, 4] squared-L2 scale.
"""

from __future__ import annotations

import jax.numpy as jnp

from pslam.ops.lbd import line_dist_matrix

DESC_TH = 0.8  # squared-L2 gate (unit descriptors)
DESC_TH_LOOSE = 1.2
COS_F2F = 0.9397  # cos(20 deg), SearchByGeomNApearance th_angle
COS_PROJ = 0.9848  # cos(10 deg), SearchByProjection th_angle
LEN_RATIO = 0.75  # min/max line-length ratio (LSDmatcher.cpp:196-200)


def _dir_cos_matrix(dir_a, dir_b):
    """|cos| of the angle between line directions, (Na, Nb)."""
    return jnp.abs(jnp.einsum("ai,bi->ab", dir_a, dir_b))


def _directions(sp, ep):
    d = ep - sp
    return d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-9)


def mutual_nn_float(dist, valid_a, valid_b, max_dist, ratio, extra_mask=None):
    """Float-matrix analogue of ops.match.mutual_nn_match."""
    BIG = jnp.asarray(1e9, dist.dtype)
    d = jnp.where(valid_a[:, None] & valid_b[None, :], dist, BIG)
    if extra_mask is not None:
        d = jnp.where(extra_mask, d, BIG)
    neg = -d
    import jax

    top2_v, top2_i = jax.lax.top_k(neg, 2)
    best = -top2_v[:, 0]
    second = -top2_v[:, 1]
    best_j = top2_i[:, 0]
    col_best = jnp.argmin(d, axis=0)
    mutual = col_best[best_j] == jnp.arange(d.shape[0])
    ok = (best <= max_dist) & (best < ratio * second) & mutual
    return jnp.where(ok, best_j, -1), best


def match_lines_f2f(
    desc_a, sp_a, ep_a, valid_a,
    desc_b, sp_b, ep_b, valid_b,
    width: float, height: float,
    max_dist: float = DESC_TH,
    ratio: float = 0.85,
):
    """Frame-to-frame line matching (SearchByGeomNApearance semantics).

    Returns (idx (Na,) int32 into b or -1, dist (Na,))."""
    dist = line_dist_matrix(desc_a, desc_b)
    cos = _dir_cos_matrix(_directions(sp_a, ep_a), _directions(sp_b, ep_b))
    dW, dH = 0.1 * width, 0.1 * height

    def close(pa, pb):  # either endpoint within (dW, dH)
        return (jnp.abs(pa[:, None, 0] - pb[None, :, 0]) <= dW) & (
            jnp.abs(pa[:, None, 1] - pb[None, :, 1]) <= dH
        )

    pos_ok = close(sp_a, sp_b) | close(ep_a, ep_b)
    mask = (cos >= COS_F2F) & pos_ok
    return mutual_nn_float(dist, valid_a, valid_b, max_dist, ratio, mask)


def point_to_segment_dist(p, sp, ep):
    """Distance from points (..., 2) to segments (..., 2)/(..., 2)."""
    d = ep - sp
    len2 = jnp.maximum(jnp.sum(d * d, axis=-1), 1e-12)
    t = jnp.clip(jnp.sum((p - sp) * d, axis=-1) / len2, 0.0, 1.0)
    proj = sp + t[..., None] * d
    return jnp.linalg.norm(p - proj, axis=-1)


def match_lines_projection(
    proj_sp, proj_ep, dir_w, desc_m, valid_m,
    sp_f, ep_f, desc_f, valid_f,
    radius: float,
    max_dist: float = DESC_TH_LOOSE,
):
    """Match projected map lines to frame lines.

    proj_sp/proj_ep: (M, 2) projected 3D endpoints of the map lines;
    dir_w valid_m desc_m: map-line data; sp_f/...: frame lines.
    Gates: both projected endpoints within ``radius`` of the frame segment,
    direction cos >= cos(10 deg), length ratio >= 0.75, descriptor distance.
    Returns (idx (M,) int32 into frame lines or -1, dist (M,))."""
    dist = line_dist_matrix(desc_m, desc_f)

    d_sp = point_to_segment_dist(
        proj_sp[:, None, :], sp_f[None, :, :], ep_f[None, :, :]
    )
    d_ep = point_to_segment_dist(
        proj_ep[:, None, :], sp_f[None, :, :], ep_f[None, :, :]
    )
    near = (d_sp <= radius) & (d_ep <= radius)

    dir_m = _directions(proj_sp, proj_ep)
    cos = _dir_cos_matrix(dir_m, _directions(sp_f, ep_f))

    len_m = jnp.linalg.norm(proj_ep - proj_sp, axis=-1)
    len_f = jnp.linalg.norm(ep_f - sp_f, axis=-1)
    lo = jnp.minimum(len_m[:, None], len_f[None, :])
    hi = jnp.maximum(len_m[:, None], len_f[None, :])
    len_ok = lo >= LEN_RATIO * hi

    mask = near & (cos >= COS_PROJ) & len_ok
    return mutual_nn_float(dist, valid_m, valid_f, max_dist, 1.0, mask)
