"""Batched-scenes throughput: N independent reconstructions
(perspective self-calibration + BA) vmapped into one program on one chip
(BASELINE.json config row: "256 scenes x 100 views ... via vmap").

Usage: [MVRECON_PRECISION=default] python scripts/bench_batched.py \
            [n_scenes] [n_views] [ba_iters]
"""

import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

from mvrecon_tpu.runtime.cache import enable_compilation_cache

enable_compilation_cache()

from mvrecon_tpu.config import LMConfig
from mvrecon_tpu.geometry.scenes import make_synthetic_scene
from mvrecon_tpu.parallel.batched import batched_euclidean_reconstruction


def main():
    n_scenes = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    n_views = int(sys.argv[2]) if len(sys.argv) > 2 else 100
    ba_iters = int(sys.argv[3]) if len(sys.argv) > 3 else 20
    eig_method = sys.argv[4] if len(sys.argv) > 4 else "eigh"
    scene_chunk = int(sys.argv[5]) if len(sys.argv) > 5 else None
    # run-to-convergence mode: per-scene early exit at |dE| <= delta_tol
    # (the reference stopping contract, lib/bundle_adjustment.py:186-191);
    # ba_iters then bounds the budget instead of fixing it
    delta_tol = float(sys.argv[6]) if len(sys.argv) > 6 else 0.0

    dtype = jnp.float32
    keys = jax.random.split(jax.random.key(0), n_scenes)
    print(f"building {n_scenes} scenes x {n_views} views ...", flush=True)
    # one jitted vmap (see bench.py::bench_batched): the op-by-op loop is
    # thousands of tiny device executions
    gen = jax.jit(jax.vmap(
        lambda k: make_synthetic_scene(k, n_images=n_views, dtype=dtype).x
    ))
    x = gen(keys)  # (S, F, P, 2)
    print("scenes ready", x.shape, flush=True)

    # Nielsen damping: see bench.py::bench_batched for the measured win.
    # Optional 8th arg overrides init_damping (retry-lever A/B).
    c0 = float(sys.argv[8]) if len(sys.argv) > 8 else 3e-3
    config = LMConfig(
        scale_factor=4.0, delta_tol=delta_tol, max_iter=ba_iters,
        accept_divisor=1.0, init_damping=c0, damping="nielsen",
    )

    mode = sys.argv[7] if len(sys.argv) > 7 else "lanes"
    if delta_tol > 0 and mode == "compact":
        # scene compaction (batched_euclidean_to_convergence). MEASURED
        # DEAD END at this workload (256x100, tol 1e-3): 15.1 s vs 8.6 s
        # for single-phase lane-level early exit — the convergence tail
        # is the bulk (median scene ~44 iters), stragglers are already
        # near the floor, and per-phase damping restarts + power-of-two
        # continuation buckets cost more than the converged-lane waste
        # they remove. Kept for workloads with genuine straggler tails.
        from mvrecon_tpu.parallel.batched import batched_euclidean_to_convergence

        def run():
            res = batched_euclidean_to_convergence(
                x, f0=1.0, tol=1e-2, method="dual", config=config,
                eig_method=eig_method, scene_chunk=scene_chunk,
            )
            return res, np.asarray(res.error)
    else:
        def run():
            res = batched_euclidean_reconstruction(
                x, f0=1.0, tol=1e-2, method="dual", config=config,
                eig_method=eig_method, scene_chunk=scene_chunk,
            )
            errs = np.asarray(res.error)  # host round-trip
            return res, errs

    t0 = time.perf_counter()
    res, errs = run()
    print(f"first run (incl. compile): {time.perf_counter() - t0:.2f}s", flush=True)

    t0 = time.perf_counter()
    res, errs = run()
    wall = time.perf_counter() - t0
    ok = int((np.asarray(res.status) == 0).sum())
    finite = int(np.isfinite(errs).sum())
    print(
        f"batched S={n_scenes} F={n_views} BA_iters={ba_iters} eig={eig_method}: wall={wall:.3f}s "
        f"({n_scenes / wall:.1f} scenes/s), calib_ok={ok}/{n_scenes}, "
        f"finite={finite}/{n_scenes}, median E={np.nanmedian(errs):.4e}",
        flush=True,
    )
    n_iter = np.asarray(res.n_iter)
    noise_floor = 200 * n_views * 2 * 0.005**2
    print(
        f"  per-scene n_iter min/med/max = {n_iter.min()}/{int(np.median(n_iter))}/"
        f"{n_iter.max()}; converged (n_iter < budget) = "
        f"{int((n_iter < ba_iters).sum())}/{n_scenes}; "
        f"worst E = {np.nanmax(errs):.3f} ({np.nanmax(errs) / noise_floor:.2f}x "
        f"noise floor {noise_floor:.2f})",
        flush=True,
    )


if __name__ == "__main__":
    main()
