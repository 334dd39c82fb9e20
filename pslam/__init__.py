"""pslam — a structural-line RGB-D SLAM engine in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capability set of the PSL-SLAM
reference (an ORB-SLAM2 fork with structural-line "LIL" landmarks; see
SURVEY.md):

- ``geometry``  — SO3/SE3/Sim3 Lie groups and pinhole/stereo camera models.
- ``ops``       — device kernels: image pyramid, FAST/rBRIEF, line detection,
                  LBD descriptors, Hamming match matrices, RANSAC fits.
- ``models``    — struct-of-arrays map state: frames, keyframes, map points,
                  map lines, structural-line (LIL) landmarks, covisibility.
- ``solver``    — robust Gauss-Newton/LM with Schur complement: pose
                  optimization, local/global BA, Sim3, essential-graph solve.
- ``parallel``  — mesh sharding of the BA edge list / reduced camera assembly.
- ``pipeline``  — host orchestrator: tracking, local mapping, loop closing,
                  system facade (the reference's thread split becomes async
                  dispatch over versioned map snapshots).
- ``io``        — TUM/ICL dataset loaders, synthetic RGB-D scene generator,
                  trajectory writers (TUM format), map checkpointing.
- ``utils``     — typed configs, timers, metrics (ATE/RPE).

Design notes (vs the C++/OpenCV/g2o reference):
- fixed-capacity, masked SoA state everywhere — no pointers, no std::set;
- all hot paths are jitted pure functions; host code only does bookkeeping;
- distribution is jax.sharding over an explicit Mesh (psum/all_gather
  between devices), not threads.
"""

import jax as _jax

# On the GPU a float32 matmul at default precision runs in TF32 (about three
# decimal digits); geometry / solver chains (pose composition, Schur
# assembly) need full f32. Sites that want the fast path (bf16 one-hot
# scatters, descriptor products) request lower precision explicitly.
_jax.config.update("jax_default_matmul_precision", "highest")

__version__ = "0.1.0"

