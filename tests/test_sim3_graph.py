"""OptimizeSim3 + essential-graph pose-graph optimization (SURVEY.md S5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pslam.geometry import se3_exp
from pslam.geometry.camera import Camera, project
from pslam.geometry.lie import (
    Sim3,
    sim3_compose,
    sim3_exp,
    sim3_inverse,
    sim3_log,
)
from pslam.solver.sim3_graph import (
    PoseGraphProblem,
    optimize_essential_graph,
    optimize_sim3,
)

CAM = Camera(fx=500.0, fy=500.0, cx=320.0, cy=240.0)


def _rand_sim3(rng, rot=0.2, trans=0.5, sig=0.2):
    z = np.concatenate(
        [
            rng.normal(0, rot, 3),
            rng.normal(0, trans, 3),
            [rng.normal(0, sig)],
        ]
    ).astype(np.float32)
    return sim3_exp(jnp.asarray(z))


class TestOptimizeSim3:
    def _problem(self, fix_scale, noise=0.3):
        rng = np.random.default_rng(0)
        N = 80
        X2 = rng.uniform([-2, -2, 2], [2, 2, 6], (N, 3)).astype(np.float32)
        s = 1.0 if fix_scale else 1.4
        xi = np.array([0.1, -0.05, 0.15, 0.3, -0.2, 0.1], np.float32)
        T = np.asarray(se3_exp(jnp.asarray(xi)))
        X1 = s * (X2 @ T[:3, :3].T) + T[:3, 3]  # g12: 2 -> 1
        uv1 = np.array(project(CAM, jnp.asarray(X1)))
        uv1 += rng.normal(0, noise, uv1.shape).astype(np.float32)
        uv2 = np.asarray(project(CAM, jnp.asarray(X2)))
        g_true = Sim3(
            s=jnp.asarray(np.float32(s)),
            R=jnp.asarray(T[:3, :3]),
            t=jnp.asarray(T[:3, 3]),
        )
        return X1, X2, uv1, uv2, g_true, rng

    @pytest.mark.parametrize("fix_scale", [False, True])
    def test_converges_from_perturbed_init(self, fix_scale):
        X1, X2, uv1, uv2, g_true, rng = self._problem(fix_scale)
        N = len(X1)
        dz = np.zeros(7, np.float32)
        dz[:6] = rng.normal(0, 0.03, 6)
        if not fix_scale:
            dz[6] = 0.05
        g_init = sim3_compose(sim3_exp(jnp.asarray(dz)), g_true)
        ones = jnp.ones(N, jnp.float32)
        res = optimize_sim3(
            CAM, g_init, jnp.asarray(X1), jnp.asarray(X2), jnp.asarray(uv1),
            jnp.asarray(uv2), ones, ones, jnp.ones(N, bool),
            fix_scale=fix_scale,
        )
        assert int(res.n_inliers) >= N - 5
        err = np.asarray(sim3_log(sim3_compose(res.g12, sim3_inverse(g_true))))
        assert np.abs(err).max() < 0.01, err
        if fix_scale:
            assert float(res.g12.s) == pytest.approx(1.0, abs=1e-5)

    def test_outliers_gated(self):
        X1, X2, uv1, uv2, g_true, rng = self._problem(False, noise=0.2)
        N = len(X1)
        bad = rng.choice(N, 15, replace=False)
        uv1 = uv1.copy()
        uv1[bad] += rng.uniform(30, 80, (15, 2)).astype(np.float32)
        ones = jnp.ones(N, jnp.float32)
        res = optimize_sim3(
            CAM, g_true, jnp.asarray(X1), jnp.asarray(X2), jnp.asarray(uv1),
            jnp.asarray(uv2), ones, ones, jnp.ones(N, bool),
        )
        inl = np.asarray(res.inlier)
        assert not inl[bad].any()
        assert inl.sum() >= N - 20
        err = np.asarray(sim3_log(sim3_compose(res.g12, sim3_inverse(g_true))))
        assert np.abs(err).max() < 0.02


class TestEssentialGraph:
    def test_loop_correction_distributes_drift(self):
        """Odometry chain with accumulated drift + one loop edge to the
        (fixed) first KF: after optimization every relative edge error and
        the loop error shrink (Optimizer.cc:2536 behavior)."""
        rng = np.random.default_rng(1)
        K = 12
        # Ground-truth poses on a circle (camera-from-world).
        gt = []
        for k in range(K):
            a = 2 * np.pi * k / K
            xi = np.array(
                [0.0, a, 0.0, np.cos(a), 0.0, np.sin(a)], np.float32
            )
            gt.append(np.asarray(se3_exp(jnp.asarray(xi))))
        gt_sim = [
            Sim3(
                s=jnp.float32(1.0),
                R=jnp.asarray(T[:3, :3]),
                t=jnp.asarray(T[:3, 3]),
            )
            for T in gt
        ]
        # True odometry measurements S_ji for consecutive pairs (j = i+1).
        meas = [
            sim3_compose(gt_sim[i + 1], sim3_inverse(gt_sim[i]))
            for i in range(K - 1)
        ]
        # Drifting estimates: integrate measurements corrupted by noise.
        est = [gt_sim[0]]
        for i in range(K - 1):
            noisy = sim3_compose(
                sim3_exp(
                    jnp.asarray(
                        np.r_[
                            rng.normal(0, 0.01, 3),
                            rng.normal(0, 0.02, 3),
                            rng.normal(0, 0.005),
                        ].astype(np.float32)
                    )
                ),
                meas[i],
            )
            est.append(sim3_compose(noisy, est[i]))
        # Loop edge K-1 -> 0 with the TRUE relative transform.
        loop_meas = sim3_compose(gt_sim[0], sim3_inverse(gt_sim[K - 1]))

        E = K  # K-1 odometry + 1 loop
        e_i = np.r_[np.arange(K - 1), [K - 1]].astype(np.int32)
        e_j = np.r_[np.arange(1, K), [0]].astype(np.int32)
        all_meas = meas + [loop_meas]
        # Measurement convention: error = log(Sji * Si * Sj^-1), Sji maps
        # i-frame to j-frame: Sji = Sj * Si^-1  => store with (i=e_j? ) --
        # here edge (i, j) uses Sji = S_j S_i^-1 and error contracts S_i, S_j.
        S_meas = Sim3(
            s=jnp.stack([m.s for m in all_meas]),
            R=jnp.stack([m.R for m in all_meas]),
            t=jnp.stack([m.t for m in all_meas]),
        )
        # error = log(Sji ∘ Si ∘ Sj^-1): for edge (i -> j), Sji = Sj Si^-1.
        # Our stored all_meas[k] = S_{j} S_{i}^{-1} already; but _edge_error
        # composes (Sji, Si, Sj^-1) which is exactly identity for perfect
        # estimates. Wait: Sji Si Sj^-1 = Sj Si^-1 Si Sj^-1 = I. Correct.
        S0 = Sim3(
            s=jnp.stack([e.s for e in est]),
            R=jnp.stack([e.R for e in est]),
            t=jnp.stack([e.t for e in est]),
        )
        fixed = np.zeros(K, bool)
        fixed[0] = True
        prob = PoseGraphProblem(
            S=S0,
            fixed=jnp.asarray(fixed),
            vertex_valid=jnp.ones(K, bool),
            e_i=jnp.asarray(e_i),
            e_j=jnp.asarray(e_j),
            e_Sji=S_meas,
            e_valid=jnp.ones(E, bool),
        )

        def total_err(S):
            err = 0.0
            for k in range(E):
                Si = jax.tree.map(lambda a: a[e_i[k]], S)
                Sj = jax.tree.map(lambda a: a[e_j[k]], S)
                e = sim3_log(
                    sim3_compose(
                        jax.tree.map(lambda a: a[k], S_meas),
                        sim3_compose(Si, sim3_inverse(Sj)),
                    )
                )
                err += float(jnp.sum(e * e))
            return err

        err0 = total_err(S0)
        S_opt = optimize_essential_graph(prob, n_iters=20)
        err1 = total_err(S_opt)
        assert err1 < err0 * 0.05, (err0, err1)
        # Fixed vertex untouched.
        np.testing.assert_allclose(np.asarray(S_opt.t)[0], np.asarray(S0.t)[0])
        # Vertices land near ground truth (gauge fixed by vertex 0).
        for k in range(K):
            Sk = jax.tree.map(lambda a: a[k], S_opt)
            d = sim3_log(sim3_compose(Sk, sim3_inverse(gt_sim[k])))
            assert float(jnp.abs(d).max()) < 0.08, (k, np.asarray(d))
