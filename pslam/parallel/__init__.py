"""Mesh distribution: sharded bundle adjustment over jax.sharding meshes.

The reference has no distributed computing at all (SURVEY.md §2.3); this
package is new design per BASELINE.json's north star: observation edges are
sharded across devices, per-shard partial Hessian/gradient blocks are
combined with psum across devices, and the reduced camera solve is replicated.
"""

from pslam.parallel.sharded_ba import (  # noqa: F401
    make_ba_mesh,
    sharded_local_bundle_adjustment,
)
