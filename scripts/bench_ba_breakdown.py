"""Phase breakdown of one chunked-BA LM iteration at scale: build-system
scan vs camera solve vs back-substitution scan. Guides kernel optimization.

Usage: [MVRECON_PRECISION=default] python scripts/bench_ba_breakdown.py \
            [n_points] [n_views] [chunk]
"""

import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

from mvrecon_tpu.runtime.cache import enable_compilation_cache

enable_compilation_cache()

from mvrecon_tpu.geometry.scenes import make_synthetic_scene
from mvrecon_tpu.models.bundle_adjustment import BAState, gauge_mask, normalize_gauge
from mvrecon_tpu.models.bundle_adjustment_chunked import (
    _backsub_and_trial,
    _build_system,
    chunk_points,
)


def timed(name, fn, *args, n=3):
    out = jax.block_until_ready(fn(*args))
    best = np.inf
    for _ in range(n):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    print(f"{name}: {best:.3f}s", flush=True)
    return out


def main():
    n_points = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    n_views = int(sys.argv[2]) if len(sys.argv) > 2 else 1000
    chunk = int(sys.argv[3]) if len(sys.argv) > 3 else 4096

    dtype = jnp.float32
    key = jax.random.key(0)
    scene = make_synthetic_scene(
        key, n_images=n_views, n_slices=n_points // 20, n_angles=20, dtype=dtype
    )
    x = scene.x.transpose(1, 0, 2)
    X0, R0, t0_, _ = normalize_gauge(scene.X, scene.R, scene.t, "x-up_z-forward")
    cam = BAState(
        X=jnp.zeros((0, 3), dtype), f=scene.K[:, 0, 0], u=scene.K[:, :2, 2],
        t=t0_, R=R0,
    )
    free = gauge_mask(n_views, "x-up_z-forward", dtype)
    vis = jnp.ones((n_points, 1), dtype)
    x_ch, vis_ch, X_ch = chunk_points(x, vis, X0, chunk)
    c = jnp.asarray(1e-4, dtype)

    build = jax.jit(
        lambda cam, X_ch, x_ch, vis_ch, c: _build_system(
            cam, X_ch, x_ch, vis_ch, free, 1.0, c
        )
    )
    a, b, e, _ = timed("build_system scan", build, cam, X_ch, x_ch, vis_ch, c)
    print(f"  E={float(np.asarray(e)):.4e}")

    a_j, b_j = jnp.asarray(a), jnp.asarray(b)
    solve_lu = jax.jit(lambda a, b: jnp.linalg.solve(a, b))
    timed("camera solve (LU)", solve_lu, a_j, b_j)

    def solve_chol(a, b):
        import jax.scipy.linalg as jsl

        cfac = jsl.cho_factor(a)
        return jsl.cho_solve(cfac, b)

    solve_ch = jax.jit(solve_chol)
    timed("camera solve (Cholesky)", solve_ch, a_j, b_j)

    delta = jnp.asarray(np.asarray(solve_lu(a_j, b_j))) * free
    backsub = jax.jit(
        lambda cam, X_ch, x_ch, vis_ch, c, delta: _backsub_and_trial(
            cam, cam, X_ch, x_ch, vis_ch, free, 1.0, c, delta
        )
    )
    timed("backsub+trial scan", backsub, cam, X_ch, x_ch, vis_ch, c, delta)


if __name__ == "__main__":
    main()
