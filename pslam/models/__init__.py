"""Struct-of-arrays map data model (replaces reference L4: Map, MapPoint,
KeyFrame, covisibility graph — src/Map.cc, src/MapPoint.cc, src/KeyFrame.cc).

Pointer-webs and std::sets become fixed-capacity arrays with validity masks:
host-side numpy for bookkeeping (insert/cull/counters), zero-copy views
shipped to device programs for the hot paths.
"""

from pslam.models.map_state import MapState  # noqa: F401
