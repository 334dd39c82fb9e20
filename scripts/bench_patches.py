"""Microbenchmark patch-extraction strategies on the default device."""

import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


R = 30
SIZE = 32
N = 1000


def timeit(name, fn, *args):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def loop(*args):
        def body(c, _):
            def perturb(x):
                if jnp.issubdtype(x.dtype, jnp.floating):
                    return x + (c * 1e-30).astype(x.dtype)
                return x

            args_c = jax.tree_util.tree_map(perturb, args)
            out = fn(*args_c)
            leaves = jax.tree_util.tree_leaves(out)
            s = sum(jnp.sum(x.astype(jnp.float32)) for x in leaves if x.size)
            return c + s * 1e-20, None

        c, _ = jax.lax.scan(body, jnp.float32(0.0), None, length=R)
        return c

    jax.block_until_ready(loop(*args))
    t0 = time.time()
    jax.block_until_ready(loop(*args))
    dt = (time.time() - t0) / R * 1e3
    log(f"{name:34s} {dt:8.3f} ms")
    return dt


def main():
    import jax
    import jax.numpy as jnp

    L, H, W = 8, 480, 640
    rng = np.random.default_rng(0)
    stack = jnp.asarray(rng.normal(size=(L, H, W)).astype(np.float32))
    y0 = jnp.asarray(rng.integers(0, H - SIZE, N).astype(np.int32))
    x0 = jnp.asarray(rng.integers(0, W - SIZE, N).astype(np.int32))
    lvl = jnp.asarray(rng.integers(0, L, N).astype(np.int32))

    def vmap_slice(stack, y0, x0, lvl):
        def one(y, x, l):
            return jax.lax.dynamic_slice(stack[l], (y, x), (SIZE, SIZE))

        return jax.vmap(one)(y0, x0, lvl)

    def row_gather_onehot(stack, y0, x0, lvl):
        flat = stack.reshape(L * H, W)
        row_idx = (lvl * H + y0)[:, None] + jnp.arange(SIZE)[None, :]
        rows = flat[row_idx]  # (N, SIZE, W)
        col = x0[:, None, None] + jnp.arange(SIZE)[None, None, :]
        onehot = (jnp.arange(W)[None, :, None] == col).astype(stack.dtype)
        return jnp.einsum(
            "nrw,nwj->nrj", rows, onehot, preferred_element_type=jnp.float32
        )

    def row_gather_onehot_bf16(stack, y0, x0, lvl):
        flat = stack.reshape(L * H, W)
        row_idx = (lvl * H + y0)[:, None] + jnp.arange(SIZE)[None, :]
        rows = flat[row_idx]
        col = x0[:, None, None] + jnp.arange(SIZE)[None, None, :]
        onehot = (jnp.arange(W)[None, :, None] == col).astype(jnp.bfloat16)
        return jnp.einsum(
            "nrw,nwj->nrj",
            rows.astype(jnp.bfloat16),
            onehot,
            preferred_element_type=jnp.float32,
        )

    def two_onehot(stack, y0, x0, lvl):
        # Row selection ALSO as a matmul: (N*SIZE, L*H) one-hot is too big;
        # instead per-level canvas contraction. Skipped.
        return None

    r1 = timeit("vmap dynamic_slice", vmap_slice, stack, y0, x0, lvl)
    r2 = timeit("row gather + onehot f32", row_gather_onehot, stack, y0, x0, lvl)
    r3 = timeit(
        "row gather + onehot bf16", row_gather_onehot_bf16, stack, y0, x0, lvl
    )

    a = np.asarray(vmap_slice(stack, y0, x0, lvl))
    b = np.asarray(row_gather_onehot(stack, y0, x0, lvl))
    log("max abs diff f32:", np.abs(a - b).max())


if __name__ == "__main__":
    main()


def extra():
    import jax
    import jax.numpy as jnp

    L, H, W = 8, 480, 640
    rng = np.random.default_rng(0)
    stack = jnp.asarray(rng.normal(size=(L, H, W)).astype(np.float32))
    y0 = jnp.asarray(rng.integers(0, H - SIZE, N).astype(np.int32))
    x0 = jnp.asarray(rng.integers(0, W - SIZE, N).astype(np.int32))
    lvl = jnp.asarray(rng.integers(0, L, N).astype(np.int32))

    def row_gather_onehot_hi(stack, y0, x0, lvl):
        flat = stack.reshape(L * H, W)
        row_idx = (lvl * H + y0)[:, None] + jnp.arange(SIZE)[None, :]
        rows = flat[row_idx]
        col = x0[:, None, None] + jnp.arange(SIZE)[None, None, :]
        onehot = (jnp.arange(W)[None, :, None] == col).astype(stack.dtype)
        return jnp.einsum(
            "nrw,nwj->nrj", rows, onehot,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )

    def row_gather_take(stack, y0, x0, lvl):
        flat = stack.reshape(L * H, W)
        row_idx = (lvl * H + y0)[:, None] + jnp.arange(SIZE)[None, :]
        rows = flat[row_idx]  # (N, SIZE, W)
        col = (x0[:, None] + jnp.arange(SIZE)[None, :])[:, None, :]
        return jnp.take_along_axis(
            rows, jnp.broadcast_to(col, (N, SIZE, SIZE)), axis=2
        )

    def double_row_gather(stack, y0, x0, lvl):
        # Gather rows, transpose, gather "rows" again (both gathers on the
        # second-minor axis, lanes contiguous).
        flat = stack.reshape(L * H, W)
        row_idx = (lvl * H + y0)[:, None] + jnp.arange(SIZE)[None, :]
        rows = flat[row_idx].reshape(N * SIZE, W)  # (N*SIZE, W)
        rt = rows.reshape(N, SIZE, W).transpose(0, 2, 1).reshape(N * W, SIZE)
        col_idx = (
            (jnp.arange(N) * W)[:, None] + x0[:, None] + jnp.arange(SIZE)[None]
        )
        cols = rt[col_idx.reshape(-1)]  # (N*SIZE, SIZE) = cols of patch
        return cols.reshape(N, SIZE, SIZE).transpose(0, 2, 1)

    timeit("row gather + onehot HIGHEST", row_gather_onehot_hi, stack, y0, x0, lvl)
    timeit("row gather + take_along", row_gather_take, stack, y0, x0, lvl)
    timeit("double row gather", double_row_gather, stack, y0, x0, lvl)

    def vmap_slice(stack, y0, x0, lvl):
        def one(y, x, l):
            return jax.lax.dynamic_slice(stack[l], (y, x), (SIZE, SIZE))

        return jax.vmap(one)(y0, x0, lvl)

    a = np.asarray(vmap_slice(stack, y0, x0, lvl))
    for nm, f in [("hi", row_gather_onehot_hi), ("take", row_gather_take),
                  ("dbl", double_row_gather)]:
        b = np.asarray(f(stack, y0, x0, lvl))
        log(nm, "max abs diff:", np.abs(a - b).max())


extra()
