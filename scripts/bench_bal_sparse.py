"""BAL-scale sparse-BA benchmark.

Generates a sequential-capture problem directly in the observation-list
layout — ground-truth hemisphere cameras + curved-tube cloud (the
reference demo geometry at scale), sliding-window visibility, pixel
noise, gross outliers, perturbed init — and runs the O(n_obs)-memory
sparse core (``models/bundle_adjustment_sparse.py``: segment-sum blocks
+ SCHUR_JACOBI-preconditioned CG camera steps).

The default shape is the real-BAL class the dense-mask cores cannot
hold: 1M points x 1,600 cameras x 10M observations (0.6% fill — the
dense (P, F, 2) layout alone would be 13 GB; the observation list is
~160 MB). No file round-trip: the dense arrays never exist anywhere.

Usage: python scripts/bench_bal_sparse.py [n_points] [n_cams] [window]
           [outlier_frac] [iters] [cg_max_iter]
Prints one JSON line.
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
from mvrecon_tpu.geometry.scenes import (
    curved_tube_points,
    sample_hemisphere_points,
)
from mvrecon_tpu.geometry.camera import intrinsics, look_at
from mvrecon_tpu.models.bundle_adjustment_sparse import (
    SparseObs,
    bundle_adjust_sparse,
)
from mvrecon_tpu.ops.procrustes import aligned_rmse


def make_sparse_problem(n_points, n_cams, window, outlier_frac=0.02,
                        noise=0.005, seed=0, dtype=np.float64):
    """Observation-list problem, generated chunked so nothing dense ever
    materializes. Returns (obs arrays, ground truth, camera arrays).

    Generation is pinned to the host CPU backend (many tiny camera/point
    ops; the result is shipped to the device once)."""
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        key = jax.random.key(seed)
        k_pos, k_tgt = jax.random.split(key)
        pos = sample_hemisphere_points(k_pos, n_cams, 5.0, dtype=jnp.float64)
        targets = 0.5 * jax.random.normal(
            k_tgt, (n_cams, 3), dtype=jnp.float64
        )
        R, t = look_at(pos, targets)
        K = intrinsics(jnp.full((n_cams,), 1.0, dtype=jnp.float64), 1.0)
        X = np.asarray(
            curved_tube_points(n_points // 20, 20, dtype=jnp.float64)
        )
    n_points = X.shape[0]

    rng = np.random.default_rng(seed)
    # sliding-window visibility: point p seen by `window` consecutive cams
    lo = rng.integers(0, n_cams - window + 1, n_points)
    point_idx = np.repeat(np.arange(n_points, dtype=np.int64), window)
    cam_idx = (lo[:, None] + np.arange(window)[None, :]).reshape(-1)
    n_obs = point_idx.shape[0]

    # project only the observed pairs, in chunks (camera matrices once)
    Rn, tn, Kn = np.asarray(R), np.asarray(t), np.asarray(K)
    rt = Rn.transpose(0, 2, 1)
    trans = -np.einsum("fij,fj->fi", rt, tn)
    pm = np.einsum(
        "fij,fjk->fik", Kn, np.concatenate([rt, trans[..., None]], axis=-1)
    )  # (F, 3, 4)
    xy = np.empty((n_obs, 2), dtype)
    chunk = 2_000_000
    for s in range(0, n_obs, chunk):
        e = min(s + chunk, n_obs)
        pm_g = pm[cam_idx[s:e]]
        Xg = X[point_idx[s:e]]
        xh = np.concatenate([Xg, np.ones((Xg.shape[0], 1))], axis=-1)
        pqr = np.einsum("nca,na->nc", pm_g, xh)
        xy[s:e] = (pqr[:, :2] / pqr[:, 2:3]).astype(dtype)

    xy += noise * rng.standard_normal(xy.shape).astype(dtype)
    n_out = int(outlier_frac * n_obs)
    pick = rng.choice(n_obs, n_out, replace=False)
    xy[pick] += (0.5 * rng.standard_normal((n_out, 2))).astype(dtype)

    return point_idx, cam_idx, xy, X, Kn, Rn, tn


def main():
    n_points = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    n_cams = int(sys.argv[2]) if len(sys.argv) > 2 else 1_600
    window = int(sys.argv[3]) if len(sys.argv) > 3 else 10
    outlier_frac = float(sys.argv[4]) if len(sys.argv) > 4 else 0.02
    iters = int(sys.argv[5]) if len(sys.argv) > 5 else 30
    cg_max_iter = int(sys.argv[6]) if len(sys.argv) > 6 else 100
    # capacity knobs (docs/SCALING.md "Single-chip sparse capacity"):
    # argv[7] = factor dtype ("f32" | "bf16"), argv[8] = matvec chunk
    # (0 = unchunked full-N matvecs)
    if len(sys.argv) > 7 and sys.argv[7] not in ("f32", "bf16"):
        sys.exit(f"usage: argv[7] (factor dtype) must be 'f32' or 'bf16', "
                 f"got {sys.argv[7]!r}")
    factor_dtype = (
        "bfloat16" if len(sys.argv) > 7 and sys.argv[7] == "bf16" else None
    )
    mc = int(sys.argv[8]) if len(sys.argv) > 8 else 0
    matvec_chunk = mc if mc > 0 else None
    print(f"factor_dtype={factor_dtype or 'float32'} "
          f"matvec_chunk={matvec_chunk or 0}", file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    point_idx, cam_idx, xy, X_gt, K, R, t = make_sparse_problem(
        n_points, n_cams, window, outlier_frac
    )
    n_obs = point_idx.shape[0]
    n_points = X_gt.shape[0]
    gen_s = time.perf_counter() - t0
    print(
        f"sparse BAL problem: {n_cams} cams, {n_points} pts, {n_obs} obs "
        f"({n_obs / (n_points * n_cams):.2%} fill), generated in "
        f"{gen_s:.1f}s",
        file=sys.stderr, flush=True,
    )

    dtype = jnp.float32
    obs = SparseObs(
        point_idx=jnp.asarray(point_idx, jnp.int32),
        cam_idx=jnp.asarray(cam_idx, jnp.int32),
        # lane-major (2, N), transposed on host (see the core's docstring)
        xy=jnp.asarray(np.ascontiguousarray(xy.T), dtype),
        weights=jnp.ones((n_obs,), dtype),
    )
    rng = np.random.default_rng(1)
    X0 = jnp.asarray(X_gt + 0.05 * rng.standard_normal(X_gt.shape), dtype)
    t0_arr = jnp.asarray(t + 0.05 * rng.standard_normal(t.shape), dtype)
    config = LMConfig(
        scale_factor=4.0, delta_tol=1e-4, max_iter=iters,
        accept_divisor=1.0, init_damping=3e-3, damping="nielsen",
        robust="huber", huber_delta=0.02,
    )

    def run():
        res = bundle_adjust_sparse(
            obs, X0, jnp.asarray(K, dtype), jnp.asarray(R, dtype), t0_arr,
            f0=1.0, axis="x-up_z-forward", config=config,
            cg_tol=1e-2, cg_max_iter=cg_max_iter,
            factor_dtype=factor_dtype, matvec_chunk=matvec_chunk,
        )
        jax.block_until_ready(res)
        return res

    run()  # compile + warm-up
    start = time.perf_counter()
    res = run()
    wall = time.perf_counter() - start

    rmse = float(aligned_rmse(res.X, jnp.asarray(X_gt, dtype)))
    out = {
        "cams": n_cams, "points": n_points, "observations": n_obs,
        "fill_frac": round(n_obs / (n_points * n_cams), 5),
        "outlier_frac": outlier_frac,
        "wall_s": round(wall, 3),
        "n_iter": int(res.n_iter),
        "n_solver_retries": int(res.log["n_solver_retries"]),
        "cg_iters_total": int(res.log["cg_iters_total"]),
        "error": float(res.error),
        "aligned_rmse_vs_gt": round(rmse, 5),
        "backend": jax.default_backend(),
        "factor_dtype": factor_dtype or "float32",
        "matvec_chunk": matvec_chunk or 0,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
