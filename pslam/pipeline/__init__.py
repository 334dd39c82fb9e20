"""Host orchestrator: tracking, local mapping, loop closing, system facade.

The reference's 3-thread pipeline (System.cc:86-113) becomes a sequential
host loop dispatching fused device programs; the map is the only mutable
state and device programs only see immutable snapshots (this replaces the
Map::mMutexMapUpdate design wholesale).
"""

from pslam.pipeline.system import SlamSystem  # noqa: F401
