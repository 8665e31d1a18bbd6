"""Retry-count sweep at the north star.

The phase ledger (BASELINE.md) bounds what faster *builds* can give;
the untried lever is the *number* of builds: 13 retries for 10 accepted
iterations. Two candidate reducers, both order-preserving in real
arithmetic (so only their f32 rounding matters):

1. ``jacobi_scaling`` — symmetric diag scaling of the camera system
   before the Cholesky (``LMConfig.jacobi_scaling``): the f/u/t/omega
   columns differ by orders of magnitude, and a better-conditioned
   factorization rounds the step less.
2. ``init_damping`` — the Nielsen controller pays 1 rejected build each
   time the start value is off; sweep around the shipped 3e-3.

Usage: python scripts/sweep_retry.py [n_points] [n_views] [iters]
Prints one JSON line per configuration (wall, retries, E).
"""

import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")

from mvrecon_tpu.runtime.cache import enable_compilation_cache

enable_compilation_cache()

import jax
import jax.numpy as jnp

from mvrecon_tpu.config import LMConfig
from mvrecon_tpu.geometry.scenes import make_synthetic_scene
from mvrecon_tpu.models.bundle_adjustment_chunked import bundle_adjust_chunked


def build_problem(n_points, n_views, dtype=jnp.float32):
    key = jax.random.key(0)
    scene = make_synthetic_scene(
        key, n_images=n_views, n_slices=n_points // 20, n_angles=20,
        dtype=dtype,
    )
    k1, k2 = jax.random.split(key)
    X0 = scene.X + 0.05 * jax.random.normal(k1, scene.X.shape, dtype=dtype)
    t0 = scene.t + 0.05 * jax.random.normal(k2, scene.t.shape, dtype=dtype)
    return scene.x.transpose(1, 0, 2), X0, scene.K, scene.R, t0


def main():
    n_points = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    n_views = int(sys.argv[2]) if len(sys.argv) > 2 else 1000
    iters = int(sys.argv[3]) if len(sys.argv) > 3 else 10
    chunk = 768

    x, X0, K, R, t0 = build_problem(n_points, n_views)

    # optional 4th arg: comma-separated init_damping values (no-jacobi
    # extension sweep; e.g. "0.01,0.02,0.03")
    if len(sys.argv) > 4:
        configs = [{"jacobi_scaling": False, "init_damping": float(c)}
                   for c in sys.argv[4].split(",")]
    else:
        configs = []
        for jacobi in (False, True):
            for c0 in (3e-3, 1e-3, 1e-2):
                configs.append({"jacobi_scaling": jacobi, "init_damping": c0})

    for kw in configs:
        config = LMConfig(
            scale_factor=4.0, delta_tol=0.0, max_iter=iters,
            accept_divisor=1.0, damping="nielsen", **kw,
        )

        def run():
            res = bundle_adjust_chunked(
                x, X0, K, R, t0, f0=1.0, axis="x-up_z-forward",
                config=config, chunk_size=chunk,
            )
            err = float(res.error)
            retries = int(res.log["n_solver_retries"])
            jax.block_until_ready(res)
            return err, retries

        run()  # compile + warm-up
        times, err, retries = [], None, None
        for _ in range(3):
            start = time.perf_counter()
            err, retries = run()
            times.append(time.perf_counter() - start)
        print(json.dumps({
            **kw,
            "wall_s_median": round(float(np.median(times)), 3),
            "wall_s_spread": [round(min(times), 3), round(max(times), 3)],
            "retries": retries,
            "reprojection_error": err,
        }), flush=True)


if __name__ == "__main__":
    main()
