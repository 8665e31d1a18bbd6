"""Experiment: does a DLT re-triangulation of the points
between perspective self-calibration and BA cut the BA iterations needed
to reach the noise floor?

Runs the pipeline at a configurable scale, printing the per-iteration BA
error curve (record_log) for three inits:
  calib      — calibration's own X (the round-4 baseline: 40 iters at
               100k x 1000)
  dlt        — X re-triangulated from the calibrated cameras
  dlt+damp   — same, with init_damping=1e-2 (the north-star retry lever)

Usage: python scripts/exp_pipeline_init.py [n_points] [n_views] [ba_iters]
           [platform] [mode] [boot_iters]
mode: "all" (three full-scale variants) or "boot" (calibration +
subsample-BA curve + hierarchical full BA only — the device-scale probe)
"""

import sys
import time

sys.path.insert(0, ".")

import numpy as np

import jax

if len(sys.argv) > 4:
    jax.config.update("jax_platforms", sys.argv[4])

from mvrecon_tpu.runtime.cache import enable_compilation_cache

enable_compilation_cache()

import jax.numpy as jnp

from mvrecon_tpu.config import LMConfig
from mvrecon_tpu.geometry.scenes import make_synthetic_scene
from mvrecon_tpu.models.bundle_adjustment_chunked import bundle_adjust_chunked
from mvrecon_tpu.ops.triangulation import triangulate
from mvrecon_tpu.parallel.mesh import make_mesh
from mvrecon_tpu.parallel.sharded_calibration import (
    sharded_perspective_self_calibration,
)


def main():
    n_points = int(sys.argv[1]) if len(sys.argv) > 1 else 20_000
    n_views = int(sys.argv[2]) if len(sys.argv) > 2 else 200
    ba_iters = int(sys.argv[3]) if len(sys.argv) > 3 else 40
    mode = sys.argv[5] if len(sys.argv) > 5 else "all"
    boot_iters = int(sys.argv[6]) if len(sys.argv) > 6 else 16
    chunk = 768

    key = jax.random.key(0)
    scene = make_synthetic_scene(
        key, n_images=n_views, n_slices=n_points // 20, n_angles=20,
        dtype=jnp.float32,
    )
    x_fp = scene.x  # (F, P, 2)
    noise_floor = n_points * n_views * 2 * 0.005**2
    mesh = make_mesh({"points": 1})

    t0 = time.perf_counter()
    calib = sharded_perspective_self_calibration(
        mesh, x_fp, f0=1.0, tol=1e-2, method="dual"
    )
    jax.block_until_ready(calib.X)
    print(f"calibration: status={int(calib.status)} "
          f"{time.perf_counter() - t0:.2f}s", flush=True)

    if mode == "all":
        t0 = time.perf_counter()
        X_dlt = triangulate(x_fp, calib.K, calib.R, calib.t, f0=1.0)
        jax.block_until_ready(X_dlt)
        print(f"DLT re-triangulation: {time.perf_counter() - t0:.2f}s",
              flush=True)

    # hierarchical: converge the cameras on a strided point subsample
    # (Schur cost ~ 3P(9F)^2 scales with P), then DLT-re-triangulate all
    # points from the converged cameras, then a short full-scale BA
    sub = max(n_points // 10, 200)
    stride = n_points // sub
    idx = jnp.arange(0, stride * sub, stride)
    t0 = time.perf_counter()
    cfg_sub = LMConfig(
        scale_factor=4.0, delta_tol=0.0, max_iter=boot_iters,
        accept_divisor=1.0, init_damping=3e-3, damping="nielsen",
        record_log=True,
    )
    res_sub = bundle_adjust_chunked(
        x_fp.transpose(1, 0, 2)[idx], calib.X[idx], calib.K, calib.R,
        calib.t, f0=1.0, axis="x-up_z-forward", config=cfg_sub,
        chunk_size=min(chunk, sub),
    )
    jax.block_until_ready(res_sub.R)
    sub_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    X_h = triangulate(x_fp, res_sub.K, res_sub.R, res_sub.t, f0=1.0)
    jax.block_until_ready(X_h)
    dlt_wall = time.perf_counter() - t0
    sub_floor = sub * n_views * 2 * 0.005**2
    sub_curve = np.asarray(res_sub.log["reprojection_error"]) / sub_floor
    print(f"subsample BA ({sub} pts, {boot_iters} iters): "
          f"E/floor={float(res_sub.error) / sub_floor:.3f} "
          f"retries={int(res_sub.log['n_solver_retries'])} "
          f"wall={sub_wall:.2f}s  DLT: {dlt_wall:.2f}s\n"
          f"  sub curve: "
          + " ".join(f"{v:.2f}" for v in sub_curve), flush=True)

    variants = {
        "calib": (calib.X, 3e-3, calib),
        "dlt": (X_dlt, 3e-3, calib),
        "hier": (X_h, 3e-3, res_sub),
    } if mode == "all" else {
        "hier": (X_h, 3e-3, res_sub),
    }
    for name, (X0, c0, cams) in variants.items():
        config = LMConfig(
            scale_factor=4.0, delta_tol=0.0, max_iter=ba_iters,
            accept_divisor=1.0, init_damping=c0, damping="nielsen",
            record_log=True,
        )
        t0 = time.perf_counter()
        res = bundle_adjust_chunked(
            x_fp.transpose(1, 0, 2), X0, cams.K, cams.R, cams.t,
            f0=1.0, axis="x-up_z-forward", config=config, chunk_size=chunk,
        )
        curve = np.asarray(res.log["reprojection_error"])
        wall = time.perf_counter() - t0
        rel = curve / noise_floor
        to_floor = next(
            (i for i, v in enumerate(rel) if v <= 1.05), None
        )
        print(f"{name:9s} wall={wall:7.2f}s retries="
              f"{int(res.log['n_solver_retries'])} "
              f"E/floor per iter: "
              + " ".join(f"{v:.2f}" for v in rel[: ba_iters + 1])
              + f"  -> iters to 1.05x floor: {to_floor}", flush=True)


if __name__ == "__main__":
    main()
