"""Estimation core: robust Gauss-Newton / Levenberg-Marquardt with Schur
complement over struct-of-arrays landmark blocks.

Replaces the reference's vendored g2o stack (Thirdparty/g2o) and
src/Optimizer.cc: graph construction becomes fixed-capacity edge lists;
marginalized landmark vertices become batched 3x3 block inversions; the
reduced camera system is assembled with segment-sums (psum-able across a
device mesh) and solved dense.
"""

from pslam.solver.robust import (  # noqa: F401
    huber_weight,
    CHI2_MONO,
    CHI2_STEREO,
)
from pslam.solver.reproj import (  # noqa: F401
    mono_residual_jac,
    stereo_residual_jac,
)
from pslam.solver.pose_opt import pose_optimization, PoseObs  # noqa: F401
from pslam.solver.local_ba import local_bundle_adjustment, BAProblem  # noqa: F401
