"""Fused pose-optimization edge terms as a Pallas kernel (Triton route, GPU).

One LM iteration of PoseOptimization (reference src/Optimizer.cc:239-1023)
needs, from the point-edge list: residuals, analytic Jacobians, Huber
weights, the 6x6 normal equations and the robust cost. This kernel computes
them in one launch. Each block owns a tile of edges and writes its partial
normal equations; blocks run in parallel, so the partials are summed
outside.

Per block, the three residual rows (u, v, ur) of each edge give three
(TE, 16) matrices A = sqrt(w) [J (6 columns) | r | 0]; P = sum A^T A holds
H = P[:6, :6], -b = P[:6, 6] and the robust cost P[6, 6].

Packing:
    data: (8, E) f32 rows [X0, X1, X2, obs_u, obs_v, obs_ur, inv_sigma2,
          active] (world points; obs_ur < 0 marks mono edges)
    par:  (32,) f32 [T_cw row-major (16), fx, fy, cx, cy, bf, use_huber, 0..]
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from pslam.solver.robust import CHI2_MONO, CHI2_STEREO

TE = 256  # edges per block
W = 16  # A's padded width (Triton products need dimensions >= 16)


def _kernel(data_ref, par_ref, p_ref, chi2_ref):
    R00, R01, R02, t0 = (par_ref[k] for k in range(0, 4))
    R10, R11, R12, t1 = (par_ref[k] for k in range(4, 8))
    R20, R21, R22, t2 = (par_ref[k] for k in range(8, 12))
    fx, fy, cx, cy, bf = (par_ref[k] for k in range(16, 21))
    use_huber = par_ref[21] > 0.5
    X0, X1, X2, obs_u, obs_v, obs_r, inv_s2, act = (
        data_ref[k, :] for k in range(8)
    )

    x = R00 * X0 + R01 * X1 + R02 * X2 + t0
    y = R10 * X0 + R11 * X1 + R12 * X2 + t1
    z = R20 * X0 + R21 * X1 + R22 * X2 + t2
    iz = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    iz2 = iz * iz

    u = fx * x * iz + cx
    v = fy * y * iz + cy
    is_stereo = obs_r >= 0.0
    sm = jnp.where(is_stereo, 1.0, 0.0)
    r0 = obs_u - u
    r1 = obs_v - v
    r2 = (obs_r - (u - bf * iz)) * sm
    chi2 = (r0 * r0 + r1 * r1 + r2 * r2) * inv_s2
    chi2_ref[:] = chi2

    delta = jnp.where(is_stereo, CHI2_STEREO**0.5, CHI2_MONO**0.5)
    e = jnp.sqrt(jnp.maximum(chi2, 1e-12))
    w_rob = jnp.where(use_huber & (e > delta), delta / e, 1.0)
    sw = jnp.sqrt(jnp.maximum(w_rob * inv_s2 * act, 0.0))

    # Analytic Jacobian rows (solver/reproj.py stereo_residual_jac):
    # row_u = [a, 0, b], row_v = [0, c, d], row_r = [a, 0, b + e2] with
    # a = fx/z, b = -fx x/z^2, c = fy/z, d = -fy y/z^2, e2 = bf/z^2;
    # J = -(row . [[0,z,-y,1,0,0],[-z,0,x,0,1,0],[y,-x,0,0,0,1]]).
    a = fx * iz
    b = -fx * x * iz2
    c = fy * iz
    d = -fy * y * iz2
    be = b + bf * iz2
    zero = jnp.zeros_like(a)
    rows = (
        ((-(b * y), -(a * z - b * x), a * y, -a, zero, -b), r0, sw),
        ((-(d * y - c * z), d * x, -(c * x), zero, -c, -d), r1, sw),
        ((-(be * y), -(a * z - be * x), a * y, -a, zero, -be), r2, sw * sm),
    )
    col = jax.lax.broadcasted_iota(jnp.int32, (TE, W), 1)
    P = jnp.zeros((W, W), jnp.float32)
    for J, r, s in rows:
        A = jnp.zeros((TE, W), jnp.float32)
        for k, v_k in enumerate(J + (r,)):
            A = jnp.where(col == k, (v_k * s)[:, None], A)
        P += pl.dot(A, A, trans_a=True, precision=jax.lax.Precision.HIGHEST)
    p_ref[:, :] = P


@partial(jax.jit, static_argnames=("interpret",))
def pose_terms_fused(data, par, interpret: bool = False):
    """data (8, E) f32, par (32,) f32 -> (H (6, 6), b (6,), cost (),
    chi2 (E,)). Edges are padded to a multiple of TE with active = 0."""
    E = data.shape[1]
    Ep = -(-E // TE) * TE
    G = Ep // TE
    P, chi2 = pl.pallas_call(
        _kernel,
        grid=(G,),
        in_specs=[
            pl.BlockSpec((8, TE), lambda g: (0, g)),
            pl.BlockSpec((32,), lambda g: (0,)),
        ],
        out_specs=[
            pl.BlockSpec((W, W), lambda g: (g, 0)),
            pl.BlockSpec((TE,), lambda g: (g,)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((G * W, W), jnp.float32),
            jax.ShapeDtypeStruct((Ep,), jnp.float32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="pose_terms",
    )(jnp.pad(data, ((0, 0), (0, Ep - E))), par)
    P = P.reshape(G, W, W).sum(0)
    return P[:6, :6], -P[:6, 6], P[6, 6], chi2[:E]


def pack_pose_data(po):
    """PoseObs -> the kernel's (8, E) data block (active = po.valid here;
    the caller overwrites row 7 per round)."""
    return jnp.stack(
        [
            po.X_w[:, 0], po.X_w[:, 1], po.X_w[:, 2],
            po.obs[:, 0], po.obs[:, 1], po.obs[:, 2],
            po.inv_sigma2, po.valid.astype(jnp.float32),
        ],
        axis=0,
    )


def pack_pose_params(cam, T, use_huber):
    """Camera + pose + Huber flag -> the kernel's (32,) parameter row."""
    extras = jnp.asarray([cam.fx, cam.fy, cam.cx, cam.cy, cam.bf], jnp.float32)
    hub = jnp.where(use_huber, 1.0, 0.0).reshape(1)
    return jnp.concatenate(
        [T.reshape(16).astype(jnp.float32), extras, hub,
         jnp.zeros(10, jnp.float32)]
    )
