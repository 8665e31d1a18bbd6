"""Single-chip sparse-BA capacity benchmark — everything generated ON
device.

`bench_bal_sparse.py` builds its problem on the host, which is right
for the BAL-interchange story but makes set-up dominate at 100M
observations (2+ GB of raw observation bytes). Here the synthetic problem (the same hemisphere-
cameras + curved-tube cloud + sliding-window visibility as the BAL
bench) is generated by one jitted function on the device itself, so
the measured quantity is pure single-chip capacity + wall:

    python scripts/bench_sparse_capacity.py [n_points] [n_cams] [window]
        [iters] [factor_dtype: f32|bf16] [cg_max_iter] [matvec_chunk|0]
        [factor_mode: stored|recompute] [obs_chunk|0]

Prints one JSON line (wall, iterations, retries, CG totals, converged
error vs the noise-floor estimate, aligned RMSE vs ground truth, and
the device's peak-memory stats when the backend reports them).
"""

import json
import sys
import time
from functools import partial


sys.path.insert(0, ".")

from mvrecon_tpu.runtime.cache import enable_compilation_cache

enable_compilation_cache()

import jax
import jax.numpy as jnp

from mvrecon_tpu.config import LMConfig
from mvrecon_tpu.geometry.camera import intrinsics, look_at
from mvrecon_tpu.geometry.scenes import (
    curved_tube_points,
    sample_hemisphere_points,
)
from mvrecon_tpu.models.bundle_adjustment_sparse import (
    SparseObs,
    bundle_adjust_sparse,
)
from mvrecon_tpu.ops.procrustes import aligned_rmse


@partial(jax.jit, static_argnames=("n_points", "n_cams", "window"))
def generate(key, n_points, n_cams, window, noise=0.005, outlier_frac=0.02):
    """Device-side problem generation: O(n_obs) work, zero host traffic.
    Same geometry family as scripts/bench_bal_sparse.py::make_sparse_problem
    (hemisphere cameras looking at a curved-tube cloud, sliding-window
    visibility, pixel noise + gross outliers, perturbed init)."""
    dt = jnp.float32
    kc, kt, kl, kn, ko, km, kx, kp = jax.random.split(key, 8)
    pos = sample_hemisphere_points(kc, n_cams, 5.0, dtype=dt)
    targets = 0.5 * jax.random.normal(kt, (n_cams, 3), dt)
    R, t = look_at(pos, targets)
    K = intrinsics(jnp.full((n_cams,), 1.0, dt), 1.0)
    X = curved_tube_points(n_points // 20, 20, dtype=dt)
    npts = X.shape[0]
    n_obs = npts * window

    lo = jax.random.randint(kl, (npts,), 0, n_cams - window + 1, jnp.int32)
    point_idx = jnp.repeat(jnp.arange(npts, dtype=jnp.int32), window)
    cam_idx = (lo[:, None]
               + jnp.arange(window, dtype=jnp.int32)[None, :]).reshape(-1)

    # camera matrices as twelve (F,) rows; per-observation projection by
    # 1-D gathers (the sparse core's own lane-major convention).
    # HIGHEST precision: a default-precision einsum (TF32 on the GPU)
    # makes the generated observations INCONSISTENT with the f32 ground
    # truth far above the noise floor — the solver then rejects every
    # step
    from mvrecon_tpu.config import STATE_HIGHEST

    rt = jnp.swapaxes(R, -1, -2)
    trans = -jnp.einsum("fij,fj->fi", rt, t, precision=STATE_HIGHEST)
    pm = jnp.einsum(
        "fij,fjk->fik", K, jnp.concatenate([rt, trans[..., None]], -1),
        precision=STATE_HIGHEST,
    ).reshape(n_cams, 12)
    pg = tuple(pm[:, i][cam_idx] for i in range(12))
    Xg = tuple(X[:, i][point_idx] for i in range(3))
    p = pg[0] * Xg[0] + pg[1] * Xg[1] + pg[2] * Xg[2] + pg[3]
    q = pg[4] * Xg[0] + pg[5] * Xg[1] + pg[6] * Xg[2] + pg[7]
    r = pg[8] * Xg[0] + pg[9] * Xg[1] + pg[10] * Xg[2] + pg[11]

    xy = jnp.stack([p / r, q / r])  # (2, N) lane-major
    xy = xy + noise * jax.random.normal(kn, (2, n_obs), dt)
    out_mask = jax.random.uniform(ko, (n_obs,), dt) < outlier_frac
    xy = xy + jnp.where(out_mask[None, :],
                        0.5 * jax.random.normal(km, (2, n_obs), dt), 0.0)

    obs = SparseObs(point_idx=point_idx, cam_idx=cam_idx, xy=xy,
                    weights=jnp.ones((n_obs,), dt))
    X0 = X + 0.05 * jax.random.normal(kx, X.shape, dt)
    t0 = t + 0.05 * jax.random.normal(kp, t.shape, dt)
    return obs, X, X0, K, R, t, t0


def _mem_stats():
    try:
        s = jax.local_devices()[0].memory_stats() or {}
        return {k: int(v) for k, v in s.items()
                if k in ("bytes_in_use", "peak_bytes_in_use",
                         "bytes_limit")}
    except Exception:
        return {}


def main():
    n_points = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    n_cams = int(sys.argv[2]) if len(sys.argv) > 2 else 1_600
    window = int(sys.argv[3]) if len(sys.argv) > 3 else 10
    iters = int(sys.argv[4]) if len(sys.argv) > 4 else 30
    fd_arg = sys.argv[5] if len(sys.argv) > 5 else "f32"
    cg_max_iter = int(sys.argv[6]) if len(sys.argv) > 6 else 100
    matvec_chunk = int(sys.argv[7]) if len(sys.argv) > 7 else 0
    matvec_chunk = matvec_chunk if matvec_chunk > 0 else None
    factor_dtype = "bfloat16" if fd_arg in ("bf16", "bfloat16") else None
    factor_mode = sys.argv[8] if len(sys.argv) > 8 else "stored"
    obs_chunk = int(sys.argv[9]) if len(sys.argv) > 9 else 0
    obs_chunk = obs_chunk if obs_chunk > 0 else (1 << 16)

    key = jax.random.key(0)
    obs, X_gt, X0, K, R, t, t0 = generate(key, n_points, n_cams, window)
    n_obs = obs.n_obs
    npts = X_gt.shape[0]
    jax.block_until_ready(obs)
    print(f"device-generated: {n_cams} cams, {npts} pts, {n_obs} obs "
          f"({n_obs / (npts * n_cams):.3%} fill)", file=sys.stderr,
          flush=True)

    config = LMConfig(
        scale_factor=4.0, delta_tol=1e-4, max_iter=iters,
        accept_divisor=1.0, init_damping=3e-3, damping="nielsen",
        robust="huber", huber_delta=0.02,
    )

    def run():
        res = bundle_adjust_sparse(
            obs, X0, K, R, t0, f0=1.0, axis="x-up_z-forward",
            config=config, cg_tol=1e-2, cg_max_iter=cg_max_iter,
            factor_dtype=factor_dtype, matvec_chunk=matvec_chunk,
            factor_mode=factor_mode, obs_chunk=obs_chunk,
        )
        jax.block_until_ready(res)
        return res

    run()  # compile + warm-up
    start = time.perf_counter()
    res = run()
    wall = time.perf_counter() - start

    rmse = float(aligned_rmse(res.X, X_gt))
    out = {
        "cams": n_cams, "points": npts, "observations": n_obs,
        "fill_frac": round(n_obs / (npts * n_cams), 6),
        "factor_dtype": fd_arg,
        "matvec_chunk": matvec_chunk,
        "factor_mode": factor_mode,
        "obs_chunk": obs_chunk,
        "wall_s": round(wall, 3),
        "n_iter": int(res.n_iter),
        "n_solver_retries": int(res.log["n_solver_retries"]),
        "cg_iters_total": int(res.log["cg_iters_total"]),
        "error": float(res.error),
        "aligned_rmse_vs_gt": round(rmse, 5),
        "backend": jax.default_backend(),
        "mem": _mem_stats(),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
