"""Hierarchical bag-of-words over 256-bit ORB descriptors.

Replaces vendored DBoW2 (reference Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h,
FORB.cpp, BowVector.cpp, FeatureVector.cpp, ScoringObject.cpp and the
ORBVocabulary typedef, include/ORBVocabulary.h:30-33).

Design (SURVEY.md §2.2): the reference walks a ~1M-leaf k^L tree per
descriptor with scalar Hamming comparisons; here the descent becomes L
rounds of (N, k) Hamming matrices — gather the k children of each
descriptor's current node, argmin, descend. The inverted-file index
(KeyFrameDatabase) becomes a dense (K, W) tf-idf matrix so BoW scoring and
shared-word counting are single matmul-shaped ops instead of list walks.

Vocabulary training is host-side binary k-medians (bit-majority centroids),
mirroring DBoW2's k-means++ build (TemplatedVocabulary.h create()); it runs
once at startup (the reference instead parses the ~1M-word ORBvoc.txt for
minutes, System.cc:61-72).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from pslam.ops.match import hamming_matrix


class Vocabulary(NamedTuple):
    """k^L tree. Level l (0-based) holds k^(l+1) node descriptors; the
    children of node j at level l are rows j*k .. j*k+k-1 of level l+1.

    node_desc: tuple of (k^(l+1), 32) uint8 arrays, one per level.
    idf: (W,) float32 word weights (W = k^L leaves).
    """

    node_desc: tuple
    idf: jnp.ndarray

    @property
    def k(self) -> int:
        return self.node_desc[0].shape[0]

    @property
    def levels(self) -> int:
        return len(self.node_desc)

    @property
    def n_words(self) -> int:
        return self.node_desc[-1].shape[0]


# ---------------------------------------------------------------------------
# Training (host, numpy)
# ---------------------------------------------------------------------------


def _bit_majority(desc_bits: np.ndarray) -> np.ndarray:
    """(N, 256) {0,1} -> (256,) majority-vote centroid bits."""
    return (desc_bits.sum(axis=0) * 2 >= desc_bits.shape[0]).astype(np.uint8)


def _hamming_np(a_bits: np.ndarray, b_bits: np.ndarray) -> np.ndarray:
    """(Na, 256) x (Nb, 256) {0,1} -> (Na, Nb) int32."""
    return (a_bits[:, None, :] != b_bits[None, :, :]).sum(-1).astype(np.int32)


def _kmedians(bits: np.ndarray, k: int, rng: np.random.Generator, iters: int = 8):
    """Binary k-medians with k-means++ seeding. Returns (centroids (k,256),
    assignment (N,)). Pads with duplicated centroids if N < k."""
    n = len(bits)
    if n == 0:
        return np.zeros((k, 256), np.uint8), np.zeros(0, np.int64)
    # k-means++ seeding on Hamming distance.
    first = int(rng.integers(n))
    cents = [bits[first]]
    d = _hamming_np(bits, bits[first : first + 1])[:, 0].astype(np.float64)
    for _ in range(1, min(k, n)):
        p = d * d
        s = p.sum()
        idx = int(rng.integers(n)) if s <= 0 else int(
            rng.choice(n, p=p / s)
        )
        cents.append(bits[idx])
        d = np.minimum(d, _hamming_np(bits, bits[idx : idx + 1])[:, 0])
    C = np.stack(cents)
    for _ in range(iters):
        dist = _hamming_np(bits, C)
        assign = dist.argmin(axis=1)
        newC = C.copy()
        for j in range(len(C)):
            sel = assign == j
            if sel.any():
                newC[j] = _bit_majority(bits[sel])
        if (newC == C).all():
            C = newC
            break
        C = newC
    dist = _hamming_np(bits, C)
    assign = dist.argmin(axis=1)
    if len(C) < k:  # pad: repeat last centroid (children never win argmin ties
        C = np.concatenate([C, np.tile(C[-1:], (k - len(C), 1))])
    return C, assign


def train_vocabulary(
    descs_u8: np.ndarray, k: int = 10, levels: int = 3, seed: int = 0
) -> Vocabulary:
    """Build a k^levels vocabulary from packed (N, 32) uint8 descriptors
    (TemplatedVocabulary::create semantics: recursive k-means++ clustering,
    TF-IDF word weights from the training set)."""
    rng = np.random.default_rng(seed)
    bits = np.unpackbits(descs_u8, axis=-1, bitorder="little")
    n = len(bits)

    level_desc = []
    # groups[i] = node index (at current level) each training desc belongs to.
    groups = np.zeros(n, np.int64)
    n_nodes = 1
    for lvl in range(levels):
        out = np.zeros((n_nodes * k, 256), np.uint8)
        new_groups = np.zeros(n, np.int64)
        for node in range(n_nodes):
            sel = np.flatnonzero(groups == node)
            C, assign = _kmedians(bits[sel], k, rng)
            out[node * k : node * k + k] = C
            new_groups[sel] = node * k + assign
        level_desc.append(np.packbits(out, axis=-1, bitorder="little"))
        groups = new_groups
        n_nodes *= k

    # IDF over the training corpus; each training descriptor = one "document
    # hit" (DBoW2 weights leaves by idf = log(N / n_i)).
    counts = np.bincount(groups, minlength=n_nodes).astype(np.float64)
    idf = np.log(max(n, 1) / np.maximum(counts, 1.0)).astype(np.float32)
    idf[counts == 0] = 0.0
    return Vocabulary(
        node_desc=tuple(jnp.asarray(d) for d in level_desc),
        idf=jnp.asarray(idf),
    )


def save_vocabulary(vocab: Vocabulary, path: str):
    """Serialize a trained vocabulary (the ORBvoc.txt analogue, but a
    compressed npz loading in milliseconds instead of minutes,
    System.cc:61-72)."""
    arrs = {f"level{l}": np.asarray(d) for l, d in enumerate(vocab.node_desc)}
    arrs["idf"] = np.asarray(vocab.idf)
    np.savez_compressed(path, **arrs)


def load_vocabulary(path: str) -> Vocabulary:
    data = np.load(path)
    levels = sorted(
        int(k.removeprefix("level")) for k in data.files if k.startswith("level")
    )
    return Vocabulary(
        node_desc=tuple(jnp.asarray(data[f"level{l}"]) for l in levels),
        idf=jnp.asarray(data["idf"]),
    )


# Packaged vocabulary trained on real ORB descriptor statistics harvested
# from rendered scenes (scripts/train_vocab.py) — the ORBvoc.txt stand-in.
PACKAGED_VOCAB = __file__.rsplit("/", 2)[0] + "/data/vocab_orb.npz"


def default_vocabulary(
    k: int = 10, levels: int = 4, n_train: int = 16384, seed: int = 3
) -> Vocabulary:
    # W = k^levels must be >> features/frame for discriminative shared-word
    # counts (the reference vocabulary has ~1M leaves for 1000 features).
    """Default vocabulary: the packaged one trained on real ORB descriptor
    statistics when its shape matches (scripts/train_vocab.py; the
    reference's ORBvoc.txt was trained offline on real imagery the same
    way, TemplatedVocabulary::create), else a deterministic fallback
    trained on random bitstrings."""
    import os

    if os.path.exists(PACKAGED_VOCAB):
        vocab = load_vocabulary(PACKAGED_VOCAB)
        if vocab.k == k and vocab.levels == levels:
            return vocab
    rng = np.random.default_rng(seed)
    descs = rng.integers(0, 256, size=(n_train, 32), dtype=np.uint8)
    return train_vocabulary(descs, k=k, levels=levels, seed=seed)


# ---------------------------------------------------------------------------
# Transform + scoring (device, jit)
# ---------------------------------------------------------------------------


def transform(vocab: Vocabulary, desc_u8, valid, levelsup: int = 1):
    """Descend all descriptors through the tree at once.

    Returns (bow (W,) float32 l1-normalized tf-idf, word (N,) int32 leaf ids,
    node (N,) int32 node ids ``levelsup`` levels above the leaves — the
    FeatureVector grouping DBoW2 uses to bucket SearchByBoW).
    Invalid features get word = -1 and contribute nothing.
    """
    k = vocab.k
    n = desc_u8.shape[0]
    node = jnp.zeros(n, jnp.int32)
    node_up = jnp.zeros(n, jnp.int32)
    BIG = jnp.int32(1 << 20)
    for lvl, lvl_desc in enumerate(vocab.node_desc):
        # Distances to ALL nodes of this level as one matmul, then mask to
        # the current node's k children (a (N, k, 32) runtime-index gather
        # is the other formulation; ROADMAP design item 1).
        d = hamming_matrix(desc_u8, lvl_desc)  # (N, n_nodes_lvl)
        parent = jnp.arange(lvl_desc.shape[0], dtype=jnp.int32) // k
        d = jnp.where(parent[None, :] == node[:, None], d, BIG)
        node = jnp.argmin(d, axis=-1).astype(jnp.int32)
        if lvl == len(vocab.node_desc) - 1 - levelsup:
            node_up = node
    word = jnp.where(valid, node, -1)
    W = vocab.n_words
    tf = jnp.zeros(W, jnp.float32).at[jnp.clip(word, 0)].add(
        valid.astype(jnp.float32)
    )
    bow = tf * vocab.idf
    bow = bow / jnp.maximum(jnp.sum(jnp.abs(bow)), 1e-12)
    return bow, word, jnp.where(valid, node_up, -1)


def score_l1(bow_q, bow_db):
    """DBoW2 L1 score (ScoringObject.cpp L1Scoring): 1 - 0.5*|q-d|_1, which
    for L1-normalized nonnegative vectors equals sum_i min(q_i, d_i).
    bow_q: (W,); bow_db: (K, W). Returns (K,) scores in [0, 1]."""
    return jnp.sum(jnp.minimum(bow_q[None, :], bow_db), axis=-1)


def shared_words(bow_q, bow_db):
    """(K,) count of words present in both query and each DB row — the
    inverted-file "common words" accumulation (KeyFrameDatabase.cc:84-103)."""
    return jnp.sum((bow_db > 0) & (bow_q[None, :] > 0), axis=-1).astype(
        jnp.int32
    )


def bow_group_mask(node_a, node_b):
    """(Na,) x (Nb,) FeatureVector node ids -> (Na, Nb) same-bucket mask, the
    SearchByBoW candidate restriction (ORBmatcher.cc:159-288): only features
    that fall under the same vocabulary node are match candidates."""
    return (node_a[:, None] == node_b[None, :]) & (node_a[:, None] >= 0)


__all__ = [
    "Vocabulary",
    "train_vocabulary",
    "default_vocabulary",
    "transform",
    "score_l1",
    "shared_words",
    "bow_group_mask",
    "hamming_matrix",
]
