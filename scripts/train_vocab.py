"""Train the packaged BoW vocabulary on REAL ORB descriptor statistics.

VERDICT r2 item 6: the default vocabulary was trained on random bitstrings;
real rBRIEF bits are correlated (intensity-comparison tests over natural
image patches), so word discrimination on real imagery was unvalidated.
This harvests descriptors from many rendered viewpoints across several
differently-textured scenes (the same projective-texture renderer the
integration tests use — the closest thing to natural imagery available in
this environment), trains the k^L tree with the k-means++/k-medians build
(TemplatedVocabulary::create semantics), and writes
pslam/data/vocab_orb.npz, which default_vocabulary() then prefers.

Usage: python scripts/train_vocab.py [k] [levels]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from pslam.io.synthetic import (
        BoxRoom,
        ClosedRoom,
        loop_trajectory,
        render_sequence,
    )
    from pslam.ops.bow import save_vocabulary, train_vocabulary
    from pslam.ops.orb import extract_orb
    from pslam.utils.config import SlamConfig

    k = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    levels = int(sys.argv[2]) if len(sys.argv) > 2 else 4

    cfg = SlamConfig()
    cam, orb = cfg.camera, cfg.orb

    descs = []
    scenes = [
        (BoxRoom(seed=s), None) for s in (0, 7, 21)
    ] + [
        (ClosedRoom(depth=5.0, half_w=3.0, half_h=2.0, seed=s),
         loop_trajectory(12, loops=1.0))
        for s in (3, 11)
    ]
    t0 = time.time()
    for room, poses in scenes:
        if poses is None:
            grays, _, _ = render_sequence(cam, n_frames=10, seed=room.seed,
                                          room=room)
        else:
            grays, _, _ = render_sequence(cam, poses=poses, room=room)
        for g in grays:
            f = extract_orb(jnp.asarray(g), orb)
            v = np.asarray(f.valid)
            descs.append(np.asarray(f.desc)[v])
        print(f"harvested {sum(len(d) for d in descs)} descriptors "
              f"({time.time()-t0:.0f}s)", flush=True)
    D = np.concatenate(descs)
    print(f"training k={k} L={levels} on {len(D)} real descriptors...",
          flush=True)
    t0 = time.time()
    vocab = train_vocabulary(D, k=k, levels=levels, seed=0)
    print(f"trained in {time.time()-t0:.0f}s; W={vocab.n_words}")

    out_dir = os.path.join(os.path.dirname(__file__), "..", "pslam", "data")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "vocab_orb.npz")
    save_vocabulary(vocab, out)
    print("wrote", os.path.abspath(out), os.path.getsize(out), "bytes")


if __name__ == "__main__":
    main()
