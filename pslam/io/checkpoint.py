"""Map/system checkpoint + resume.

The reference never implemented this (System.h:117-119: ``SaveMap/LoadMap``
are TODO comments); long sequences cannot resume. Here the whole SoA map
state, the BoW database/vocabulary, the tracker bookkeeping, and the
loop-closer state serialize to one compressed ``.npz`` — the map is already
pointer-free struct-of-arrays (SURVEY §7.1), so a checkpoint is a plain
array dump and resume is a plain load.
"""

from __future__ import annotations

import json

import numpy as np

_SKIP = {"cfg"}


def _map_arrays(m) -> dict:
    out = {}
    for name, val in vars(m).items():
        if name in _SKIP:
            continue
        if isinstance(val, np.ndarray):
            out[f"map.{name}"] = val
        elif isinstance(val, (int, np.integer)):
            out[f"mapscalar.{name}"] = np.int64(val)
    return out


def save_checkpoint(system, path: str):
    """Serialize a SlamSystem (map + BoW DB + vocabulary + tracker state +
    loop edges) to ``path`` (.npz)."""
    system.flush()  # commit in-flight BA + device accumulators first
    arrs = _map_arrays(system.map)

    # Tracker bookkeeping.
    arrs["sys.velocity"] = system.velocity
    arrs["sys.meta"] = np.frombuffer(
        json.dumps(
            {
                "frame_id": int(system.frame_id),
                "ref_kf": int(system.ref_kf),
                "state": system.state.name,
                "stats": {k: int(v) for k, v in system.stats.items()},
            }
        ).encode(),
        dtype=np.uint8,
    )
    if system.trajectory:
        arrs["sys.traj_ts"] = np.asarray(
            [t for t, _, _ in system.trajectory], np.float64
        )
        arrs["sys.traj_T"] = np.stack([T for _, T, _ in system.trajectory])
        arrs["sys.traj_ref"] = np.asarray(
            [r for _, _, r in system.trajectory], np.int32
        )

    if system.kf_db is not None:
        db = system.kf_db
        arrs["db.bow"] = db.bow
        arrs["db.word"] = db.word
        arrs["db.node"] = db.node
        arrs["db.present"] = db.present
        for l, nd in enumerate(db.vocab.node_desc):
            arrs[f"vocab.level{l}"] = np.asarray(nd)
        arrs["vocab.idf"] = np.asarray(db.vocab.idf)

    if system.loop_closer is not None:
        lc = system.loop_closer
        arrs["lc.loop_edges"] = np.asarray(lc.loop_edges, np.int32).reshape(
            -1, 2
        )
        arrs["lc.last_loop_seq"] = np.int64(lc.last_loop_seq)

    np.savez_compressed(path, **arrs)


def load_checkpoint(path: str, cfg=None):
    """Rebuild a SlamSystem from a checkpoint. ``cfg`` must match the
    capacities the checkpoint was written with (shapes are validated on
    assignment)."""
    import jax.numpy as jnp

    from pslam.ops.bow import Vocabulary
    from pslam.pipeline.system import SlamSystem, TrackState
    from pslam.utils.config import SlamConfig

    cfg = cfg or SlamConfig()
    data = np.load(path, allow_pickle=False)

    vocab = None
    levels = sorted(
        int(k.removeprefix("vocab.level"))
        for k in data.files
        if k.startswith("vocab.level")
    )
    if levels:
        vocab = Vocabulary(
            node_desc=tuple(
                jnp.asarray(data[f"vocab.level{l}"]) for l in levels
            ),
            idf=jnp.asarray(data["vocab.idf"]),
        )

    system = SlamSystem(cfg, vocab=vocab)
    m = system.map
    for key in data.files:
        if key.startswith("map."):
            name = key.removeprefix("map.")
            cur = getattr(m, name)
            if cur.shape != data[key].shape:
                raise ValueError(
                    f"checkpoint/{name}: shape {data[key].shape} != "
                    f"config capacity {cur.shape}"
                )
            setattr(m, name, data[key].copy())
        elif key.startswith("mapscalar."):
            setattr(m, key.removeprefix("mapscalar."), int(data[key]))

    meta = json.loads(bytes(data["sys.meta"]).decode())
    system.frame_id = meta["frame_id"]
    system.ref_kf = meta["ref_kf"]
    # The last HostFrame is not checkpointed (it is transient per-frame
    # state), so a session resumed mid-track re-enters via relocalization
    # against the restored map instead of the motion model.
    state = TrackState[meta["state"]]
    system.state = TrackState.LOST if state == TrackState.OK else state
    system.stats.update(meta["stats"])
    system.velocity = data["sys.velocity"].copy()
    if "sys.traj_ts" in data.files:
        system.trajectory = [
            (float(t), T.copy(), int(r))
            for t, T, r in zip(
                data["sys.traj_ts"], data["sys.traj_T"], data["sys.traj_ref"]
            )
        ]

    if system.kf_db is not None and "db.bow" in data.files:
        db = system.kf_db
        db.bow = data["db.bow"].copy()
        db.word = data["db.word"].copy()
        db.node = data["db.node"].copy()
        db.present = data["db.present"].copy()

    if system.loop_closer is not None and "lc.loop_edges" in data.files:
        system.loop_closer.loop_edges = [
            (int(a), int(b)) for a, b in data["lc.loop_edges"]
        ]
        system.loop_closer.last_loop_seq = int(data["lc.last_loop_seq"])

    return system
