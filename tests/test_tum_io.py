"""TUM dataset IO + rgbd_tum CLI app on a tiny generated dataset
(rgbd_tum.cc:36-176, LoadImages 180-208; Tracking.cc:214-272)."""

import os

import numpy as np
import pytest

from pslam.io.synthetic import render_sequence
from pslam.io.tum import (
    TumRgbdDataset,
    config_from_settings,
    load_rgb_gray,
    load_settings_yaml,
)
from pslam.utils.config import SlamConfig

SETTINGS = """\
%YAML:1.0
# reference-style settings (Examples/RGB-D/TUM1.yaml)
Camera.fx: 517.306408
Camera.fy: 516.469215
Camera.cx: 318.643040
Camera.cy: 255.313989
Camera.k1: 0.262383
Camera.k2: -0.953104
Camera.p1: -0.005358
Camera.p2: 0.002628
Camera.k3: 1.163314
Camera.width: 640
Camera.height: 480
Camera.fps: 30.0
Camera.bf: 40.0
ThDepth: 40.0
DepthMapFactor: 5000.0
ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def test_settings_parse(tmp_path):
    p = tmp_path / "s.yaml"
    p.write_text(SETTINGS)
    s = load_settings_yaml(str(p))
    assert s["Camera.fx"] == pytest.approx(517.306408)
    assert s["ORBextractor.nFeatures"] == 1000
    cfg = config_from_settings(s)
    assert cfg.camera.width == 640
    assert cfg.camera.k1 == pytest.approx(0.262383)
    assert cfg.orb.n_features == 1000
    assert cfg.orb.th_fast_hi == 20
    assert cfg.tracking.kf_max_interval == 30


@pytest.fixture(scope="module")
def tiny_dataset(tmp_path_factory):
    """Write a 6-frame synthetic sequence as a TUM-layout dataset."""
    from PIL import Image

    root = tmp_path_factory.mktemp("tumseq")
    os.makedirs(root / "rgb")
    os.makedirs(root / "depth")
    # Render through the TUM1 distortion model so the images are consistent
    # with the distortion coefficients in SETTINGS.
    s = {}
    for line in SETTINGS.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line or line.startswith("%") or ":" not in line:
            continue
        k, _, v = line.partition(":")
        try:
            s[k.strip()] = float(v) if "." in v else int(v)
        except ValueError:
            pass
    cam = config_from_settings(s).camera
    grays, depths, poses = render_sequence(
        cam, n_frames=6, seed=3, use_distortion=True
    )
    rows = []
    for i, (g, d) in enumerate(zip(grays, depths)):
        t = 1305031102.0 + i / 30.0
        rgb8 = np.clip(g, 0, 255).astype(np.uint8)
        Image.fromarray(np.stack([rgb8] * 3, -1)).save(root / "rgb" / f"{i}.png")
        d16 = np.clip(d * 5000.0, 0, 65535).astype(np.uint16)
        Image.fromarray(d16).save(root / "depth" / f"{i}.png")
        rows.append(f"{t:.6f} rgb/{i}.png {t:.6f} depth/{i}.png")
    assoc = root / "assoc.txt"
    assoc.write_text("# assoc\n" + "\n".join(rows) + "\n")
    (root / "settings.yaml").write_text(SETTINGS)
    return root, grays, depths


def test_dataset_roundtrip(tiny_dataset):
    root, grays, depths = tiny_dataset
    ds = TumRgbdDataset(str(root), str(root / "assoc.txt"))
    assert len(ds) == 6
    gray, depth, ts = ds[0]
    assert gray.dtype == np.float32 and gray.shape == grays[0].shape
    assert abs(ts - 1305031102.0) < 1e-4
    # Gray roundtrips through the luma weights within quantization error.
    assert np.abs(gray - np.clip(grays[0], 0, 255).astype(np.uint8)).max() < 1.0
    # Depth roundtrips through the 16-bit/5000 encoding.
    assert np.abs(depth - depths[0]).max() < 1e-3


def test_rgb_gray_luma(tmp_path):
    from PIL import Image

    rgb = np.zeros((4, 4, 3), np.uint8)
    rgb[..., 0] = 100
    rgb[..., 1] = 50
    rgb[..., 2] = 200
    p = tmp_path / "x.png"
    Image.fromarray(rgb).save(p)
    g = load_rgb_gray(str(p))
    assert g == pytest.approx(
        np.full((4, 4), 0.299 * 100 + 0.587 * 50 + 0.114 * 200, np.float32)
    )


def test_rgbd_tum_app(tiny_dataset, tmp_path, monkeypatch):
    root, _, _ = tiny_dataset
    monkeypatch.chdir(tmp_path)
    from pslam.apps.rgbd_tum import main

    rc = main([
        str(root / "settings.yaml"), str(root), str(root / "assoc.txt"),
        "tiny", "--no-lines", "--no-loop", "--kitti",
    ])
    assert rc == 0
    f = np.loadtxt("f_tiny.txt")
    assert f.shape == (6, 8)
    kf = np.atleast_2d(np.loadtxt("kf_tiny.txt"))
    assert kf.shape[1] == 8 and kf.shape[0] >= 1
    kitti = np.loadtxt("kitti_tiny.txt")
    assert kitti.shape == (6, 12)
    # First pose is the origin in both formats.
    assert f[0, 1:4] == pytest.approx([0, 0, 0], abs=1e-6)
    assert kitti[0].reshape(3, 4)[:, :3] == pytest.approx(np.eye(3), abs=1e-6)


def test_rgbd_tum_app_distorted_ate(tmp_path, monkeypatch):
    """Full CLI round trip on a DISTORTED-lens dataset (VERDICT r3 item 6):
    PNG decode, DepthMapFactor scaling, the undistort_points path driven by
    images actually rendered through the TUM1 distortion model, trajectory
    save — gated on ATE against ground truth."""
    from PIL import Image

    from pslam.utils.metrics import ate_rmse, trajectory_positions

    settings_path = tmp_path / "settings.yaml"
    settings_path.write_text(SETTINGS)
    settings = load_settings_yaml(str(settings_path))
    cfg = config_from_settings(settings)
    cam = cfg.camera
    assert cam.has_distortion

    root = tmp_path / "seq"
    os.makedirs(root / "rgb")
    os.makedirs(root / "depth")
    # 12 frames over the arc: the whole-arc trajectory is rendered at n
    # frames, so small n means violent inter-frame motion.
    n = 12
    grays, depths, poses_gt = render_sequence(
        cam, n_frames=n, seed=4, use_distortion=True
    )
    rows = []
    for i, (g, d) in enumerate(zip(grays, depths)):
        t = 1305031102.0 + i / 30.0
        rgb8 = np.clip(g, 0, 255).astype(np.uint8)
        Image.fromarray(np.stack([rgb8] * 3, -1)).save(
            root / "rgb" / f"{i}.png"
        )
        d16 = np.clip(d * 5000.0, 0, 65535).astype(np.uint16)
        Image.fromarray(d16).save(root / "depth" / f"{i}.png")
        rows.append(f"{t:.6f} rgb/{i}.png {t:.6f} depth/{i}.png")
    (root / "assoc.txt").write_text("\n".join(rows) + "\n")

    monkeypatch.chdir(tmp_path)
    from pslam.apps.rgbd_tum import main

    rc = main([
        str(settings_path), str(root), str(root / "assoc.txt"), "dist",
        "--no-lines", "--no-loop",
    ])
    assert rc == 0
    f = np.loadtxt("f_dist.txt")
    assert f.shape == (n, 8)
    est_pos = f[:, 1:4]
    gt_pos = trajectory_positions(poses_gt)
    ate = ate_rmse(est_pos, gt_pos)
    assert ate < 0.05, f"ATE {ate:.4f} m on distorted dataset"
