"""Frontend tests: FAST vs OpenCV golden values, ORB extraction invariances,
Hamming matching (SURVEY.md §4: per-kernel golden-value + property tests)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pslam.io.synthetic import checker_texture
from pslam.ops import (
    OrbConfig,
    extract_orb,
    fast_score,
    hamming_matrix,
    mutual_nn_match,
    rotation_consistency_mask,
)
from pslam.ops.match import window_mask


def make_test_image(seed=0, h=480, w=640):
    tex = checker_texture(1024, 32, seed)
    return tex[:h, :w].copy()


class TestFast:
    def test_matches_cv2_corners(self):
        cv2 = pytest.importorskip("cv2")
        img = make_test_image()
        is_c, score = fast_score(jnp.asarray(img), 20)
        ours = np.asarray(is_c)
        det = cv2.FastFeatureDetector_create(
            threshold=20, nonmaxSuppression=False
        )
        kps = det.detect(img.astype(np.uint8), None)
        cv_mask = np.zeros_like(ours)
        for kp in kps:
            cv_mask[int(kp.pt[1]), int(kp.pt[0])] = True
        # Interior only (our shifts wrap at borders).
        interior = np.zeros_like(ours)
        interior[4:-4, 4:-4] = True
        both = ours & cv_mask & interior
        cv_only = cv_mask & interior
        # Behavioral parity: we must find nearly every cv2 corner.
        recall = both.sum() / max(cv_only.sum(), 1)
        assert recall > 0.95, recall
        ours_only = ours & interior
        precision = both.sum() / max(ours_only.sum(), 1)
        assert precision > 0.95, precision

    def test_no_corners_on_flat(self):
        img = jnp.full((64, 64), 128.0)
        is_c, score = fast_score(img, 20)
        assert not bool(is_c[4:-4, 4:-4].any())


class TestExtractOrb:
    CFG = OrbConfig()

    def test_basic_extraction(self):
        img = jnp.asarray(make_test_image())
        feats = extract_orb(img, self.CFG)
        n_valid = int(feats.valid.sum())
        assert feats.uv.shape[0] == self.CFG.capacity
        assert n_valid > 0.9 * self.CFG.n_features
        uv = np.asarray(feats.uv[feats.valid])
        assert uv[:, 0].min() >= 0 and uv[:, 0].max() < 640 * 1.01
        # All 8 levels populated on a textured image.
        lv = np.asarray(feats.level[feats.valid])
        assert len(np.unique(lv)) == self.CFG.levels
        # Spatial spread: at least 60% of 80x80 blocks have a keypoint.
        occ = np.zeros((6, 8), bool)
        occ[np.minimum(uv[:, 1] // 80, 5).astype(int),
            np.minimum(uv[:, 0] // 80, 7).astype(int)] = True
        assert occ.mean() > 0.6

    def test_deterministic(self):
        img = jnp.asarray(make_test_image(3))
        f1 = extract_orb(img, self.CFG)
        f2 = extract_orb(img, self.CFG)
        np.testing.assert_array_equal(np.asarray(f1.desc), np.asarray(f2.desc))

    def test_translation_matching(self):
        """Descriptors must match across a pure image translation."""
        base = make_test_image(5, h=560, w=760)
        img_a = jnp.asarray(base[0:480, 0:640].copy())
        dy, dx = 40, 60
        img_b = jnp.asarray(base[dy : dy + 480, dx : dx + 640].copy())
        fa = extract_orb(img_a, self.CFG)
        fb = extract_orb(img_b, self.CFG)
        dist = hamming_matrix(fa.desc, fb.desc)
        # Expected correspondence: uv_b = uv_a - (dx, dy).
        pred = np.asarray(fa.uv) - np.array([dx, dy])
        box = window_mask(jnp.asarray(pred), fb.uv, 4.0)
        idx, d = mutual_nn_match(
            dist, fa.valid, fb.valid, max_dist=60, extra_mask=box
        )
        idx = np.asarray(idx)
        matched = (idx >= 0).sum()
        assert matched > 0.4 * int(fa.valid.sum()), matched
        # Matched pairs obey the translation.
        uv_b = np.asarray(fb.uv)[idx[idx >= 0]]
        err = np.abs(uv_b - pred[idx >= 0])
        assert np.median(err) < 2.0


class TestHamming:
    def test_vs_numpy_popcount(self):
        rng = np.random.default_rng(0)
        a = rng.integers(0, 256, size=(64, 32), dtype=np.uint8)
        b = rng.integers(0, 256, size=(80, 32), dtype=np.uint8)
        got = np.asarray(hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
        want = np.zeros((64, 80), np.int32)
        for i in range(64):
            for j in range(80):
                want[i, j] = bin(
                    int.from_bytes(a[i].tobytes(), "little")
                    ^ int.from_bytes(b[j].tobytes(), "little")
                ).count("1")
        np.testing.assert_array_equal(got, want)

    def test_mutual_nn_identity(self):
        rng = np.random.default_rng(1)
        a = rng.integers(0, 256, size=(50, 32), dtype=np.uint8)
        d = hamming_matrix(jnp.asarray(a), jnp.asarray(a))
        idx, dist = mutual_nn_match(d, max_dist=10, ratio=0.99)
        np.testing.assert_array_equal(np.asarray(idx), np.arange(50))
        assert np.all(np.asarray(dist) == 0)

    def test_rotation_consistency(self):
        n = 200
        rng = np.random.default_rng(2)
        ang_a = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
        # 90% consistent rotation offset of 0.3 rad, 10% random.
        ang_b = ang_a - 0.3
        bad = rng.random(n) < 0.1
        ang_b[bad] = rng.uniform(0, 2 * np.pi, bad.sum())
        mask = jnp.ones(n, bool)
        out = np.asarray(
            rotation_consistency_mask(
                jnp.asarray(ang_a), jnp.asarray(ang_b), mask
            )
        )
        assert out[~bad].mean() > 0.95
        assert out[bad].mean() < 0.5
