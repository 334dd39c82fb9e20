"""TUM RGB-D / ICL-NUIM dataset IO.

Replaces the reference's dataset plumbing: the association-file loader
(rgbd_tum.cc:180-208 ``LoadImages``), the per-frame image decode + depth
scaling (Tracking.cc:214-272 ``GrabImageRGBD``: BGR->gray convert,
``depth *= 1/DepthMapFactor``), and the OpenCV-YAML settings reader
(Tracking.cc:53-154). No OpenCV dependency: PNGs decode through PIL and the
settings files are the reference's simple flat ``key: value`` YAML dialect.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from pslam.geometry import Camera


def load_associations(path: str):
    """Parse a TUM association file: ``t_rgb rgb_rel t_depth depth_rel``
    per line, '#' comments skipped (rgbd_tum.cc:180-208)."""
    ts, rgb, dts, dep = [], [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 4:
                continue
            ts.append(float(parts[0]))
            rgb.append(parts[1])
            dts.append(float(parts[2]))
            dep.append(parts[3])
    return ts, rgb, dts, dep


def load_settings_yaml(path: str) -> dict:
    """Read the reference's flat OpenCV-YAML settings dialect
    (Examples/RGB-D/TUM1.yaml): ``Key.Sub: value`` scalars only."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or line.startswith("%") or ":" not in line:
                continue
            key, _, val = line.partition(":")
            key, val = key.strip(), val.strip()
            if not val:
                continue
            try:
                out[key] = float(val) if ("." in val or "e" in val) else int(val)
            except ValueError:
                out[key] = val.strip('"')
    return out


def config_from_settings(settings: dict, base=None):
    """Build a SlamConfig from reference-style settings keys
    (Camera.fx/.fy/.cx/.cy/.bf, ORBextractor.nFeatures/.scaleFactor/.nLevels/
    .iniThFAST/.minThFAST, ThDepth, DepthMapFactor; Tracking.cc:53-154)."""
    from pslam.ops.orb import OrbConfig
    from pslam.utils.config import SlamConfig, TrackingConfig

    base = base or SlamConfig()
    cam = Camera(
        fx=float(settings.get("Camera.fx", base.camera.fx)),
        fy=float(settings.get("Camera.fy", base.camera.fy)),
        cx=float(settings.get("Camera.cx", base.camera.cx)),
        cy=float(settings.get("Camera.cy", base.camera.cy)),
        bf=float(settings.get("Camera.bf", base.camera.bf)),
        width=int(settings.get("Camera.width", base.camera.width)),
        height=int(settings.get("Camera.height", base.camera.height)),
        k1=float(settings.get("Camera.k1", 0.0)),
        k2=float(settings.get("Camera.k2", 0.0)),
        p1=float(settings.get("Camera.p1", 0.0)),
        p2=float(settings.get("Camera.p2", 0.0)),
        k3=float(settings.get("Camera.k3", 0.0)),
    )
    orb = dataclasses.replace(
        base.orb,
        n_features=int(settings.get("ORBextractor.nFeatures",
                                    base.orb.n_features)),
        scale=float(settings.get("ORBextractor.scaleFactor", base.orb.scale)),
        levels=int(settings.get("ORBextractor.nLevels", base.orb.levels)),
        th_fast_hi=int(settings.get("ORBextractor.iniThFAST",
                                    base.orb.th_fast_hi)),
        th_fast_lo=int(settings.get("ORBextractor.minThFAST",
                                    base.orb.th_fast_lo)),
    )
    fps = float(settings.get("Camera.fps", 30.0))
    tracking = dataclasses.replace(
        base.tracking,
        th_depth_factor=float(settings.get("ThDepth",
                                           base.tracking.th_depth_factor)),
        kf_max_interval=int(fps) if fps > 0 else base.tracking.kf_max_interval,
    )
    return dataclasses.replace(base, camera=cam, orb=orb, tracking=tracking)


def _read_png(path: str) -> np.ndarray:
    from pslam.utils import require

    with require("PIL.Image", "Pillow").open(path) as im:
        return np.asarray(im)


def load_rgb_gray(path: str) -> np.ndarray:
    """Decode an RGB(A)/gray PNG to float32 grayscale, reference weights
    (cvtColor RGB2GRAY, Tracking.cc:226-238)."""
    a = _read_png(path)
    if a.ndim == 3:
        a = (
            0.299 * a[..., 0].astype(np.float32)
            + 0.587 * a[..., 1].astype(np.float32)
            + 0.114 * a[..., 2].astype(np.float32)
        )
    return np.ascontiguousarray(a, np.float32)


def load_depth(path: str, depth_map_factor: float = 5000.0) -> np.ndarray:
    """Decode a 16-bit depth PNG to float32 meters (Tracking.cc:265-268:
    ``imD.convertTo(imD, CV_32F, 1/DepthMapFactor)``)."""
    a = _read_png(path).astype(np.float32)
    if depth_map_factor > 0:
        a = a / np.float32(depth_map_factor)
    return np.ascontiguousarray(a)


@dataclasses.dataclass
class TumRgbdDataset:
    """Sequence of (gray float32 HxW, depth-in-meters float32 HxW, timestamp).

    seq_dir:     dataset root containing rgb/ and depth/
    assoc_path:  association file of (t_rgb rgb t_d depth) rows
    """

    seq_dir: str
    assoc_path: str
    depth_map_factor: float = 5000.0

    def __post_init__(self):
        self.timestamps, self._rgb, _, self._depth = load_associations(
            self.assoc_path
        )

    def __len__(self):
        return len(self.timestamps)

    def __getitem__(self, i: int):
        gray = load_rgb_gray(os.path.join(self.seq_dir, self._rgb[i]))
        depth = load_depth(
            os.path.join(self.seq_dir, self._depth[i]), self.depth_map_factor
        )
        return gray, depth, self.timestamps[i]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
