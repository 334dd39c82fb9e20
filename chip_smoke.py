"""Smoke test of the SLAM main path on one GPU.

Drives ``SlamSystem`` at the full ``SlamConfig()`` width (640x480 frames,
1000 ORB features over 8 levels, 4096-point local map, lines, LILs, BoW and
loop closing on) through the entry points a user calls, on sequences
rendered from a seed, all in this one process:

1. device check: JAX's default backend must be the GPU (no CPU fallback);
2. kernel parity: the compiled Pallas pose-terms kernel (ops/pallas_pose.py)
   against the plain jnp path at the two widths it is compiled at: 4096
   edges (tracking) and 1000 (relocalization);
3. loop circuit: 200 frames of the ClosedRoom revisit loop through
   ``track_rgbd``;
4. pipelined arc: 120 frames through ``track_rgbd_pipelined`` + ``finish``;
5. stereo: 30 frames through ``track_stereo``.

Phases 3-5 are gated on no lost frames (relocalizations or resets) and on an
ATE within ``ATE_FACTOR`` of the same phase on the CPU (``CPU_ATE_CM``,
recorded by ``scripts/smoke_reference.py``). A failed gate raises, so the
process exits non-zero. Timings are printed for information; they use
``jax.block_until_ready`` (the returned poses are host arrays).

``--four-cards`` runs only the sharded solves over a 4-device mesh against
the single-device solvers, plus a short ``distributed=True`` system run.

The last line of standard output is one JSON object naming the device.

    python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# CPU figures of each phase (cm), from ``python scripts/smoke_reference.py``
# at commit e09124e (its tracking code; "distributed" on four virtual CPU
# devices); the chip run must land within ATE_FACTOR of them. The gate holds
# the card to what the same code does on the CPU; it is no accuracy target.
# The loop figures are several times RESULTS.md's older loop row (PERF.md,
# Open questions).
CPU_ATE_CM = {
    "loop_online": 12.058736239682936,
    "loop_corrected": 8.880486903026503,
    "arc": 2.622970096910655,
    "stereo": 4.722275187989313,
    "distributed": 2.2041005225857178,
}
ATE_FACTOR = 1.5


def log(*a):
    print(*a, flush=True)


def gate(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"gate failed: {what}")
    log(f"  gate ok: {what}")


def _timing(times: np.ndarray, warm_from: int) -> str:
    warm = times[warm_from:] * 1e3
    return (
        f"first frames {times[:2].sum():.1f} s (compile), warm median "
        f"{np.median(warm):.2f} ms/frame, p90 {np.percentile(warm, 90):.2f}, "
        f"max {warm.max():.1f}, total {times.sum():.1f} s"
    )


def _lost(s) -> int:
    return int(s.stats.get("relocs", 0)) + int(s.stats.get("resets", 0))


def _ate_cm(poses, gt) -> float:
    from pslam.utils.metrics import ate_rmse, trajectory_positions

    est = trajectory_positions(np.stack(poses))
    return 100.0 * ate_rmse(est, trajectory_positions(gt)[: len(est)])


def _gate_ate(name: str, ate: float):
    ref = CPU_ATE_CM[name]
    gate(ate <= ATE_FACTOR * ref,
         f"{name} ATE {ate:.3f} cm <= {ATE_FACTOR} x CPU {ref:.3f} cm")


# Kernel-vs-plain tolerance: both paths sum the float32 edge terms at full
# (HIGHEST) precision, in different orders.
KERNEL_RTOL = 1e-4  # of each output's largest magnitude
KERNEL_TOL_T = 1e-5  # max |dT| after the whole 4x10 LM solve
# Edge counts the kernel is compiled at: the tracking local map, and one
# keyframe's features in relocalization.
KERNEL_WIDTHS = {"tracking": 4096, "relocalization": 1000}


def check_pose_kernel(E: int, what: str):
    """The compiled kernel against the plain path at E edges (30% mono,
    10% gross outliers, 10% invalid): one evaluation of the edge terms,
    then the whole LM solve."""
    import jax
    import jax.numpy as jnp

    from pslam.io.problems import pose_problem
    from pslam.ops.pallas_pose import (
        pack_pose_data, pack_pose_params, pose_terms_fused,
    )
    from pslam.solver import pose_opt
    from pslam.utils.config import SlamConfig

    cam = SlamConfig().camera
    po, T = pose_problem(cam, E, seed=1, outlier_frac=0.1)
    Tj = jnp.asarray(T)

    @jax.jit
    def plain(T):
        chi2, w, r, J, rm, cost = pose_opt._edge_terms(
            cam, T, po, True, po.valid)
        return (*pose_opt._gn_system(w, r, J, rm), cost, chi2)

    @jax.jit
    def fused(T):
        return pose_terms_fused(pack_pose_data(po),
                                pack_pose_params(cam, T, jnp.asarray(1.0)))

    for name, a, b in zip(("H", "b", "cost", "chi2"),
                          jax.device_get(plain(Tj)), jax.device_get(fused(Tj))):
        err = float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))
        gate(err <= KERNEL_RTOL, f"pose kernel {name} ({what}, E={E}): "
             f"relative error {err:.2e} <= {KERNEL_RTOL:g} (float32, HIGHEST)")
    T0 = jnp.eye(4, dtype=jnp.float32)
    T_f, T_p = (np.asarray(jax.jit(lambda T: solve(cam, T, po, 4, 10, None)[0])(T0))
                for solve in (pose_opt._pose_optimization_fused,
                              pose_opt._pose_optimization_plain))
    d = float(np.abs(T_p - T_f).max())
    gate(d <= KERNEL_TOL_T,
         f"pose LM 4x10 with the kernel ({what}, E={E}): max |dT| vs plain "
         f"{d:.2e} <= {KERNEL_TOL_T:g}")


def run_loop_circuit(n_frames: int = 200) -> dict:
    """The 200-frame ClosedRoom(seed=3) revisit loop through track_rgbd."""
    import jax

    from pslam.io.synthetic import ClosedRoom, loop_trajectory, render_sequence
    from pslam.pipeline.system import SlamSystem
    from pslam.utils.config import SlamConfig

    cfg = SlamConfig()
    room = ClosedRoom(depth=5.0, half_w=3.0, half_h=2.0, seed=3)
    grays, depths, gt = render_sequence(
        cfg.camera, poses=loop_trajectory(n_frames, loops=1.0), room=room
    )
    s = SlamSystem(cfg)
    online, times = [], np.zeros(n_frames)
    for i in range(n_frames):
        t0 = time.perf_counter()
        T = jax.block_until_ready(s.track_rgbd(grays[i], depths[i], i / 30.0))
        times[i] = time.perf_counter() - t0
        online.append(np.asarray(T))
    lc = s.loop_closer.stats if s.loop_closer is not None else {}
    out = dict(
        ate_online=_ate_cm(online, gt),
        ate_corrected=_ate_cm(list(s.poses), gt),
        kf_inserted=int(s.stats["kf_inserted"]),
        ba_runs=int(s.stats["ba_runs"]),
        loops=int(lc.get("closed", 0)),
        lost=_lost(s),
        timing=_timing(times, 20),
    )
    log(f"loop circuit ({n_frames} frames, track_rgbd): {out}")
    return out


def run_pipelined_arc(n_frames: int = 120) -> dict:
    """The 120-frame arc through track_rgbd_pipelined + finish."""
    import jax

    from pslam.io.synthetic import render_sequence
    from pslam.pipeline.system import SlamSystem
    from pslam.utils.config import SlamConfig

    cfg = SlamConfig()
    grays, depths, gt = render_sequence(cfg.camera, n_frames=n_frames, seed=0)
    s = SlamSystem(cfg)
    times = np.zeros(n_frames)
    for i in range(n_frames):
        t0 = time.perf_counter()
        jax.block_until_ready(
            s.track_rgbd_pipelined(grays[i], depths[i], i / 30.0)
        )
        times[i] = time.perf_counter() - t0
    s.finish()
    out = dict(
        ate=_ate_cm(list(s.poses), gt),
        kf_inserted=int(s.stats["kf_inserted"]),
        ba_runs=int(s.stats["ba_runs"]),
        lost=_lost(s),
        timing=_timing(times, 20),
    )
    log(f"pipelined arc ({n_frames} frames, track_rgbd_pipelined): {out}")
    return out


def run_stereo(n_frames: int = 30) -> dict:
    """30 rendered stereo pairs through track_stereo (points only)."""
    import jax

    from pslam.io.synthetic import render_stereo_sequence
    from pslam.pipeline.system import SlamSystem
    from pslam.utils.config import SlamConfig

    cfg = SlamConfig(sensor="stereo", use_lines=False)
    gl, gr, gt = render_stereo_sequence(cfg.camera, n_frames=n_frames, seed=0)
    s = SlamSystem(cfg)
    est, times = [], np.zeros(n_frames)
    for i in range(n_frames):
        t0 = time.perf_counter()
        T = jax.block_until_ready(s.track_stereo(gl[i], gr[i], i / 30.0))
        times[i] = time.perf_counter() - t0
        est.append(np.asarray(T))
    out = dict(
        ate=_ate_cm(est, gt),
        kf_inserted=int(s.stats["kf_inserted"]),
        lost=_lost(s),
        timing=_timing(times, 10),
    )
    log(f"stereo ({n_frames} frames, track_stereo): {out}")
    return out


# Sharded-vs-single tolerances, as in tests/test_parallel.py: the mesh sums
# each shard's partial normal equations in another order than one device
# does, so float32 results differ in the last bits, and the LM schedule
# amplifies that on ill-conditioned points (seen from few cameras). Poses
# and LIL states are held by their max difference, points by their median.
SHARD_TOL_T = 5e-3  # max |dT| of pose entries and |dL| of LIL states (m)
SHARD_TOL_X = 1e-3  # median |dX| of point coordinates (metres)


def _timed(f, *args):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(f(*args))
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(f(*args))
    return out, t_cold, 1e3 * (time.perf_counter() - t0)


def _compare(name, single, sharded, tol, what, stat=np.max):
    d = np.abs(np.asarray(single) - np.asarray(sharded))
    v = float(stat(d))
    gate(np.isfinite(v) and v <= tol,
         f"{name}: {stat.__name__} |d{what}| sharded vs single {v:.3e} <= "
         f"{tol:g} (max {float(d.max()):.3e})")


def run_sharded_solves(C=128, F=64, P=8192, E=32768, Q=1024, El=4096, K=128):
    """Sharded local BA, LIL-BA and essential graph on a mesh of every
    device, each against its single-device solver."""
    import jax

    from pslam.io.problems import ba_problem, graph_problem, lil_problem
    from pslam.parallel.sharded_ba import (
        make_ba_mesh,
        sharded_local_bundle_adjustment,
        sharded_local_bundle_adjustment_lil,
    )
    from pslam.parallel.sharded_graph import optimize_essential_graph_sharded
    from pslam.solver.ba_lil import local_bundle_adjustment_lil
    from pslam.solver.local_ba import local_bundle_adjustment
    from pslam.solver.sim3_graph import optimize_essential_graph
    from pslam.utils.config import SlamConfig

    mesh = make_ba_mesh()
    n = mesh.size
    log(f"mesh: {n} devices; BA C={C} F={F} P={P} E={E}, LIL Q={Q} El={El}, "
        f"graph K={K} ({K * (K - 1) // 2} edges)")
    cam = SlamConfig().camera
    prob = ba_problem(cam, C, P, E, F, seed=0)
    sched = (10, 10)

    one = jax.jit(lambda p: local_bundle_adjustment(cam, p, F, sched))
    shd = jax.jit(lambda p: sharded_local_bundle_adjustment(
        cam, p, F, mesh, sched))
    (T1, X1, *_), c1, t1 = _timed(one, prob)
    (T2, X2, *_), c2, t2 = _timed(shd, prob)
    log(f"local BA: single {t1:.2f} ms (compile+run {c1:.1f} s), "
        f"sharded x{n} {t2:.2f} ms (compile+run {c2:.1f} s)")
    _compare("local BA", T1, T2, SHARD_TOL_T, "T")
    _compare("local BA", X1, X2, SHARD_TOL_X, "X", np.median)

    lst, ledges = lil_problem(cam, prob.T_cw, Q, El, seed=1)
    lval = jax.numpy.ones(Q, bool)
    one = jax.jit(lambda p, s: local_bundle_adjustment_lil(
        cam, p, s, lval, ledges, F, sched))
    shd = jax.jit(lambda p, s: sharded_local_bundle_adjustment_lil(
        cam, p, s, lval, ledges, F, mesh, sched))
    (T1, X1, L1, *_), c1, t1 = _timed(one, prob, lst)
    (T2, X2, L2, *_), c2, t2 = _timed(shd, prob, lst)
    log(f"LIL-BA: single {t1:.2f} ms (compile+run {c1:.1f} s), "
        f"sharded x{n} {t2:.2f} ms (compile+run {c2:.1f} s)")
    _compare("LIL-BA", T1, T2, SHARD_TOL_T, "T")
    _compare("LIL-BA", X1, X2, SHARD_TOL_X, "X", np.median)
    _compare("LIL-BA", L1, L2, SHARD_TOL_T, "L")

    g = graph_problem(K, seed=2, edge_multiple=n)
    one = jax.jit(lambda p: optimize_essential_graph(p, 20))
    shd = jax.jit(lambda p: optimize_essential_graph_sharded(p, mesh, 20))
    S1, c1, t1 = _timed(one, g)
    S2, c2, t2 = _timed(shd, g)
    log(f"essential graph: single {t1:.2f} ms (compile+run {c1:.1f} s), "
        f"sharded x{n} {t2:.2f} ms (compile+run {c2:.1f} s)")
    _compare("essential graph", S1.R, S2.R, 1e-3, "R")
    _compare("essential graph", S1.t, S2.t, 1e-3, "t")


def run_distributed_system(n_frames: int = 60) -> dict:
    """SlamSystem(distributed=True) over the rendered arc; records how many
    devices hold each in-flight local-BA result."""
    import jax

    from pslam.io.synthetic import render_sequence
    from pslam.pipeline.system import SlamSystem
    from pslam.utils.config import SlamConfig

    cfg = SlamConfig(distributed=True)
    grays, depths, gt = render_sequence(cfg.camera, n_frames=n_frames, seed=0)
    s = SlamSystem(cfg)
    spread, times = set(), np.zeros(n_frames)
    for i in range(n_frames):
        t0 = time.perf_counter()
        jax.block_until_ready(s.track_rgbd(grays[i], depths[i], i / 30.0))
        times[i] = time.perf_counter() - t0
        if s._pending_ba is not None:
            T_opt = s._pending_ba["result"][0]
            spread.add(len(T_opt.sharding.device_set))
    out = dict(
        ate=_ate_cm(list(s.poses), gt),
        ba_runs=int(s.stats["ba_runs"]),
        lost=_lost(s),
        ba_result_devices=sorted(spread),
        timing=_timing(times, 20),
    )
    log(f"distributed system ({n_frames} frames, track_rgbd): {out}")
    return out


def run_four_cards():
    import jax

    n = len(jax.devices())
    gate(n == 4, f"four devices visible ({n})")
    run_sharded_solves()
    dist = run_distributed_system()
    gate(dist["lost"] == 0, "distributed system: no relocalization or reset")
    gate(dist["ba_runs"] >= 1, "distributed system: local BA committed")
    gate(n in dist["ba_result_devices"],
         f"distributed system: local BA result spread over {n} devices")
    _gate_ate("distributed", dist["ate"])


def check_device():
    import jax

    backend = jax.default_backend()
    dev = jax.devices()[0]
    if backend != "gpu" or dev.platform != "gpu":
        sys.exit(f"no GPU: JAX backend is {backend!r} ({dev.platform})")
    return dev


def print_card():
    q = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    log(q.stdout.strip())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded solves on a 4-device mesh")
    args = ap.parse_args(argv)

    dev = check_device()
    import jax

    from pslam.utils.backend import enable_compile_cache

    log(f"device: {dev.device_kind} x {len(jax.devices())}, "
        f"compile cache {enable_compile_cache()}")
    print_card()

    if args.four_cards:
        run_four_cards()
    else:
        t0 = time.perf_counter()
        for what, E in KERNEL_WIDTHS.items():
            check_pose_kernel(E, what)
        loop = run_loop_circuit()
        gate(loop["lost"] == 0, "loop circuit: no relocalization or reset")
        gate(loop["kf_inserted"] > 1, "loop circuit: keyframes inserted")
        gate(loop["ba_runs"] >= 1, "loop circuit: local BA committed")
        _gate_ate("loop_online", loop["ate_online"])
        _gate_ate("loop_corrected", loop["ate_corrected"])

        arc = run_pipelined_arc()
        gate(arc["lost"] == 0, "pipelined arc: no relocalization or reset")
        gate(arc["ba_runs"] >= 1, "pipelined arc: local BA committed")
        _gate_ate("arc", arc["ate"])

        st = run_stereo()
        gate(st["lost"] == 0, "stereo: no relocalization or reset")
        _gate_ate("stereo", st["ate"])
        log(f"all phases: {time.perf_counter() - t0:.1f} s")

    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs),
    }}), flush=True)


if __name__ == "__main__":
    main()
