"""BoW vocabulary, keyframe database, Horn/Sim3 RANSAC (SURVEY.md S5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pslam.geometry import se3_exp
from pslam.geometry.camera import Camera, project
from pslam.ops import bow as bow_ops
from pslam.solver.horn import horn_align, se3_ransac_3d3d, sim3_ransac


@pytest.fixture(scope="module")
def vocab():
    rng = np.random.default_rng(0)
    descs = rng.integers(0, 256, (4096, 32), dtype=np.uint8)
    return bow_ops.train_vocabulary(descs, k=8, levels=4, seed=1)


def _perturb(desc, n_bits, rng):
    """Flip n_bits random bits in each packed descriptor."""
    bits = np.unpackbits(desc, axis=-1, bitorder="little")
    for i in range(len(bits)):
        idx = rng.choice(256, n_bits, replace=False)
        bits[i, idx] ^= 1
    return np.packbits(bits, axis=-1, bitorder="little")


class TestBow:
    def test_tree_shapes(self, vocab):
        assert vocab.k == 8 and vocab.levels == 4
        assert vocab.n_words == 8**4
        for lvl, d in enumerate(vocab.node_desc):
            assert d.shape == (8 ** (lvl + 1), 32)

    def test_transform_normalized_and_masked(self, vocab):
        rng = np.random.default_rng(2)
        desc = rng.integers(0, 256, (64, 32), dtype=np.uint8)
        valid = np.arange(64) < 40
        bow, word, node = jax.jit(
            lambda d, v: bow_ops.transform(vocab, d, v)
        )(jnp.asarray(desc), jnp.asarray(valid))
        assert float(jnp.sum(jnp.abs(bow))) == pytest.approx(1.0, abs=1e-5)
        assert (np.asarray(word)[~valid] == -1).all()
        assert (np.asarray(word)[valid] >= 0).all()
        assert (np.asarray(word)[valid] < vocab.n_words).all()
        # node = word's ancestor one level up
        assert (
            np.asarray(node)[valid] == np.asarray(word)[valid] // vocab.k
        ).all()

    def test_self_similarity_beats_random(self, vocab):
        rng = np.random.default_rng(3)
        desc_a = rng.integers(0, 256, (128, 32), dtype=np.uint8)
        desc_b = _perturb(desc_a, 8, rng)  # same place, mild noise
        desc_c = rng.integers(0, 256, (128, 32), dtype=np.uint8)  # other place
        v = jnp.ones(128, bool)
        bow_a, _, _ = bow_ops.transform(vocab, jnp.asarray(desc_a), v)
        bow_b, _, _ = bow_ops.transform(vocab, jnp.asarray(desc_b), v)
        bow_c, _, _ = bow_ops.transform(vocab, jnp.asarray(desc_c), v)
        db = jnp.stack([bow_b, bow_c])
        s = np.asarray(bow_ops.score_l1(bow_a, db))
        # Random 256-bit codes are the worst case for BoW separation (real
        # ORB statistics cluster far more); demand a clear but modest margin.
        assert s[0] > s[1] * 1.25
        common = np.asarray(bow_ops.shared_words(bow_a, db))
        assert common[0] > common[1]

    def test_score_self_is_one(self, vocab):
        rng = np.random.default_rng(4)
        desc = rng.integers(0, 256, (64, 32), dtype=np.uint8)
        v = jnp.ones(64, bool)
        bow, _, _ = bow_ops.transform(vocab, jnp.asarray(desc), v)
        s = float(bow_ops.score_l1(bow, bow[None])[0])
        assert s == pytest.approx(1.0, abs=1e-5)


class TestKeyFrameDatabase:
    def test_reloc_candidates(self, vocab):
        from pslam.models.map_state import MapState
        from pslam.pipeline.keyframe_db import KeyFrameDatabase
        from pslam.utils.config import SlamConfig

        cfg = SlamConfig()
        ms = MapState(cfg)
        rng = np.random.default_rng(5)
        N = cfg.orb.capacity
        db = KeyFrameDatabase(vocab, cfg.caps.max_keyframes, N)

        # 4 distinct "places"; KF i sees place i % 4.
        place = [rng.integers(0, 256, (N, 32), dtype=np.uint8) for _ in range(4)]
        uv = rng.uniform(0, 400, (N, 2)).astype(np.float32)
        for i in range(8):
            desc = _perturb(place[i % 4], 6, rng)
            k = ms.add_keyframe(
                i, float(i), np.eye(4, dtype=np.float32), uv,
                np.full(N, -1, np.float32), np.zeros(N, np.int32),
                np.zeros(N, np.float32), desc, np.ones(N, bool),
                np.ones(N, np.float32), np.full(N, -1, np.int32),
            )
            b, w, nd = db.compute_bow(desc, np.ones(N, bool))
            db.add(k, b, w, nd)

        # Query near place 2 should return KFs {2, 6} (mod-4 == 2).
        qdesc = _perturb(place[2], 6, rng)
        bq, _, _ = db.compute_bow(qdesc, np.ones(N, bool))
        cands = db.detect_relocalization_candidates(bq, ms)
        assert len(cands) > 0
        assert all(int(c) % 4 == 2 for c in cands)


class TestHorn:
    def test_exact_alignment(self):
        rng = np.random.default_rng(6)
        P = rng.normal(0, 1, (10, 3)).astype(np.float32)
        xi = np.array([0.1, -0.2, 0.3, 0.2, -0.1, 0.4], np.float32)
        T = np.asarray(se3_exp(jnp.asarray(xi)))
        s_true = 1.7
        Q = s_true * (P @ T[:3, :3].T) + T[:3, 3]
        s, R, t = horn_align(jnp.asarray(P), jnp.asarray(Q))
        np.testing.assert_allclose(float(s), s_true, rtol=1e-4)
        np.testing.assert_allclose(np.asarray(R), T[:3, :3], atol=1e-4)
        np.testing.assert_allclose(np.asarray(t), T[:3, 3], atol=1e-4)

    def test_fixed_scale(self):
        rng = np.random.default_rng(7)
        P = rng.normal(0, 1, (8, 3)).astype(np.float32)
        Q = 1.0 * P + np.array([1.0, 2.0, 3.0], np.float32)
        s, R, t = horn_align(jnp.asarray(P), jnp.asarray(Q), fix_scale=True)
        assert float(s) == 1.0
        np.testing.assert_allclose(np.asarray(R), np.eye(3), atol=1e-4)
        np.testing.assert_allclose(np.asarray(t), [1, 2, 3], atol=1e-4)

    def test_batched(self):
        rng = np.random.default_rng(8)
        P = rng.normal(0, 1, (5, 4, 3)).astype(np.float32)
        Q = P * 2.0
        s, R, t = horn_align(jnp.asarray(P), jnp.asarray(Q))
        assert s.shape == (5,)
        np.testing.assert_allclose(np.asarray(s), 2.0, rtol=1e-4)


class TestRansac:
    def test_se3_ransac_with_outliers(self):
        rng = np.random.default_rng(9)
        N = 128
        X_w = rng.uniform([-2, -2, 1], [2, 2, 6], (N, 3)).astype(np.float32)
        xi = np.array([0.05, -0.03, 0.1, 0.3, -0.2, 0.15], np.float32)
        T_true = np.asarray(se3_exp(jnp.asarray(xi)))
        X_c = X_w @ T_true[:3, :3].T + T_true[:3, 3]
        # 30% outliers.
        n_out = 38
        out_idx = rng.choice(N, n_out, replace=False)
        X_c_noisy = X_c + rng.normal(0, 0.005, (N, 3)).astype(np.float32)
        X_c_noisy[out_idx] += rng.uniform(0.5, 2.0, (n_out, 3)).astype(np.float32)
        T, inl, n_in = se3_ransac_3d3d(
            jnp.asarray(X_w), jnp.asarray(X_c_noisy), jnp.ones(N, bool),
            jax.random.PRNGKey(0),
        )
        assert int(n_in) > N - n_out - 15
        np.testing.assert_allclose(np.asarray(T), T_true, atol=0.02)

    def test_sim3_ransac(self):
        rng = np.random.default_rng(10)
        cam = Camera(fx=500.0, fy=500.0, cx=320.0, cy=240.0)
        N = 96
        X1 = rng.uniform([-2, -2, 2], [2, 2, 8], (N, 3)).astype(np.float32)
        s_true = 1.3
        xi = np.array([0.02, -0.05, 0.08, 0.4, 0.1, -0.2], np.float32)
        T = np.asarray(se3_exp(jnp.asarray(xi)))  # maps frame1 -> frame2
        X2 = s_true * (X1 @ T[:3, :3].T) + T[:3, 3]
        uv1 = np.asarray(project(cam, jnp.asarray(X1)))
        uv2 = np.asarray(project(cam, jnp.asarray(X2)))
        # corrupt 25%
        n_out = 24
        oi = rng.choice(N, n_out, replace=False)
        X2c = X2.copy()
        X2c[oi] += rng.uniform(0.5, 1.5, (n_out, 3)).astype(np.float32)
        ones = np.ones(N, np.float32)
        res = sim3_ransac(
            cam, jnp.asarray(X1), jnp.asarray(X2c), jnp.asarray(uv1),
            jnp.asarray(uv2), jnp.asarray(ones), jnp.asarray(ones),
            jnp.ones(N, bool), jax.random.PRNGKey(1),
        )
        assert int(res.n_inliers) >= N - n_out - 10
        # S12 maps 2 -> 1: X1 = s12 R12 X2 + t12; check scale ~ 1/1.3.
        np.testing.assert_allclose(float(res.s12), 1 / s_true, rtol=0.05)
        X1_rec = float(res.s12) * (X2 @ np.asarray(res.R12).T) + np.asarray(
            res.t12
        )
        inl = np.asarray(res.inlier)
        np.testing.assert_allclose(X1_rec[inl], X1[inl], atol=0.05)


class TestRealVocabularyPR:
    """Place-recognition precision/recall with the PACKAGED vocabulary
    trained on real ORB statistics (scripts/train_vocab.py; VERDICT r2
    item 6): on a revisit circuit, frames must retrieve temporally-near or
    revisit frames — never unrelated viewpoints."""

    def test_packaged_vocab_loads(self):
        import os

        from pslam.ops.bow import PACKAGED_VOCAB, default_vocabulary

        assert os.path.exists(PACKAGED_VOCAB)
        vocab = default_vocabulary(k=10, levels=4)
        assert vocab.n_words == 10_000

    def test_revisit_precision_recall(self):
        import jax.numpy as jnp
        import numpy as np

        from pslam.io.synthetic import (
            ClosedRoom, loop_trajectory, render_sequence,
        )
        from pslam.ops.bow import default_vocabulary, score_l1, transform
        from pslam.ops.orb import extract_orb
        from pslam.utils.config import SlamConfig

        cfg = SlamConfig()
        n = 16
        poses = loop_trajectory(n, loops=1.0)
        room = ClosedRoom(depth=5.0, half_w=3.0, half_h=2.0, seed=5)
        grays, _, _ = render_sequence(cfg.camera, poses=poses, room=room)
        vocab = default_vocabulary(k=10, levels=4)

        bows = []
        for g in grays:
            f = extract_orb(jnp.asarray(g), cfg.orb)
            bow, _, _ = transform(vocab, f.desc, f.valid)
            bows.append(np.asarray(bow))
        B = jnp.asarray(np.stack(bows))

        # For each query frame, the best OTHER frame must be a yaw
        # neighbour (circular distance <= 2) — the sequence pans a full
        # 360 deg circle, so frame 0's revisit partners are frames 14/15.
        hits, total = 0, 0
        for q in range(n):
            s = np.asarray(score_l1(B[q], B)).copy()
            s[q] = -1.0
            best = int(np.argmax(s))
            d = min(abs(best - q), n - abs(best - q))
            total += 1
            hits += int(d <= 2)
        assert hits / total >= 0.9, f"precision {hits}/{total}"
