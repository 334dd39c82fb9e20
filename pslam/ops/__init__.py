"""Device kernels: image pyramid, FAST/rBRIEF extraction, line detection,
descriptor distance matrices, RANSAC fits.

These replace the reference's OpenCV/ORBextractor/line_descriptor hot paths
(SURVEY.md §2 "kernel-grade" rows) with batched XLA/Pallas programs: every
per-keypoint / per-cell CPU loop becomes a masked tensor op over fixed
capacities.
"""

from pslam.ops.image import (  # noqa: F401
    build_pyramid,
    gaussian_blur,
    PYR_LEVELS,
    PYR_SCALE,
)
from pslam.ops.fast import fast_score  # noqa: F401
from pslam.ops.orb import OrbFeatures, OrbConfig, extract_orb  # noqa: F401
from pslam.ops.match import (  # noqa: F401
    hamming_matrix,
    mutual_nn_match,
    rotation_consistency_mask,
)
