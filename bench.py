"""Headline benchmarks on one GPU — prints exactly one JSON line.

Workloads (all float32, generated from seed 0):

1. **headline** (the line's metric/value/vs_baseline): dense BA,
   P=10,000 x F=100 views, 10 LM iterations (delta_tol=0). Baseline: the
   reference implementation (takah29/3d-reconstruction-from-multi-view-exp,
   pure NumPy float64, single CPU process) on the *identical* workload —
   measured with scripts/measure_reference_baseline.py (the reference
   publishes no numbers; see BASELINE.md).
2. **northstar**: chunk-streamed BA, P=100,000 x F=1,000, 10 LM
   iterations, with the sustained Schur FLOP rate.
3. **covariance**: uncertainty quantification of the northstar
   reconstruction (per-point 3x3 + per-camera 9x9 blocks via the chunked
   camera-marginal Schur inverse).
4. **northstar_pipeline**: the full flagship pipeline (perspective
   self-calibration -> Euclidean upgrade -> chunked BA) at 100k points x
   1000 views.
5. **bal_large_sparse**: BAL-class sparse BA — 1M points x 1,600 cameras
   x 10M observations (0.6% fill) via the O(n_obs) observation-list core
   (bundle_adjustment_sparse.py), in one solve.
6. **bal_sparse**: Huber BA on a BAL-format problem with sliding-window
   ~20% visibility and 2% gross outliers.
7. **batched** / **batched_converged**: 256 scenes x 100 views full
   pipeline, fixed budget / run to the reference's stopping contract.

Everything runs in this one process on the default JAX backend, which
must be a GPU: without one, ``main()`` exits non-zero and prints nothing
on stdout. Every wall time ends in ``jax.block_until_ready``; the first
call of each workload compiles and is not timed.

Env knob:
  MVRECON_BENCH_ONLY=a,b        run only these fields after the headline
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

import jax
import jax.numpy as jnp

# Reference NumPy wall-clock for the same P/F/iterations (CPU, float64);
# see BASELINE.md ("mid-scale BA baseline"):
#   python scripts/measure_reference_baseline.py 10000 100 10 -> 5650.26 s
#   (94 minutes; >33 GB resident - the reference materializes a
#   (P, 9F-7, 9F-7) float64 Schur intermediate. The smaller 2000x50 config
#   measured 651.36 s.)
REFERENCE_CPU_WALL = {(10_000, 100): 5650.26, (2_000, 50): 651.36}

N_POINTS, N_VIEWS, N_ITERS = 10_000, 100, 10


def build_problem(n_points, n_views, dtype=jnp.float32):
    """Synthetic BA problem: ground-truth scene + perturbed X and t init.
    Returns (x (P, F, 2), X0, K, R, t0)."""
    from mvrecon_tpu.geometry.scenes import make_synthetic_scene

    key = jax.random.key(0)
    scene = make_synthetic_scene(
        key, n_images=n_views, n_slices=n_points // 20, n_angles=20, dtype=dtype
    )
    k1, k2 = jax.random.split(key)
    X0 = scene.X + 0.05 * jax.random.normal(k1, scene.X.shape, dtype=dtype)
    t0 = scene.t + 0.05 * jax.random.normal(k2, scene.t.shape, dtype=dtype)
    x = scene.x.transpose(1, 0, 2)  # (P, F, 2)
    return x, X0, scene.K, scene.R, t0


def noise_floor(n_obs: int, sigma: float = 0.005) -> float:
    """Expected sum of squared residuals at the optimum: 2 coordinates
    per observation with pixel noise ``sigma``."""
    return n_obs * 2 * sigma**2


def gpu_info() -> dict:
    """Device record for the JSON line; exits non-zero without a GPU."""
    devs = jax.devices()
    if jax.default_backend() != "gpu" or not devs:
        sys.exit(f"bench: needs a GPU backend, found {jax.default_backend()!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
        "nvidia_smi": smi,
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }


def bench_headline(n_points=N_POINTS, n_views=N_VIEWS):
    from mvrecon_tpu.config import LMConfig
    from mvrecon_tpu.models.bundle_adjustment import bundle_adjust

    config = LMConfig(scale_factor=2.0, delta_tol=0.0, max_iter=N_ITERS)
    x, X0, K, R, t0 = build_problem(n_points, n_views)

    def run():
        return jax.block_until_ready(bundle_adjust(
            x, X0, K, R, t0, f0=1.0, axis="x-up_z-forward", config=config
        ))

    run()  # compile + warm-up
    times = []
    for _ in range(3):
        start = time.perf_counter()
        res = run()
        times.append(time.perf_counter() - start)
    err = float(res.error)
    assert np.isfinite(err), "BA diverged"
    return {
        "points": n_points, "views": n_views, "iters": N_ITERS,
        "wall_s": min(times),
        "reprojection_error": err,
    }


def bench_northstar(n_points=100_000, n_views=1000, n_iters=10, chunk=768):
    from mvrecon_tpu.config import LMConfig
    from mvrecon_tpu.models.bundle_adjustment_chunked import bundle_adjust_chunked

    config = LMConfig(
        scale_factor=4.0, delta_tol=0.0, max_iter=n_iters,
        accept_divisor=1.0, init_damping=1e-2, damping="nielsen",
    )
    x, X0, K, R, t0 = build_problem(n_points, n_views)

    def run():
        return jax.block_until_ready(bundle_adjust_chunked(
            x, X0, K, R, t0, f0=1.0, axis="x-up_z-forward",
            config=config, chunk_size=chunk,
        ))

    run()
    times = []
    for _ in range(3):
        start = time.perf_counter()
        res = run()
        times.append(time.perf_counter() - start)
    wall = float(np.median(times))
    err = float(res.error)
    retries = int(res.log["n_solver_retries"])
    assert np.isfinite(err), "north-star BA diverged"
    # Symmetric Schur accumulation is 3 P (9F)^2 FLOPs per damped solve
    # (backsub, solve and derivative generation excluded).
    per_retry = 3 * n_points * (9 * n_views) ** 2
    stats = {
        "points": n_points, "views": n_views, "iters": n_iters,
        "wall_s": wall,
        "wall_s_spread": [min(times), max(times)],
        "retries": retries,
        "reprojection_error": err,
        "sustained_schur_tflops": retries * per_retry / wall / 1e12,
    }
    return stats, (x, res)


def bench_northstar_pipeline(n_points=100_000, n_views=1000, ba_iters=8,
                             chunk=768):
    """Full-pipeline north star: perspective self-calibration -> chunked
    BA at 100k points x 1000 views on one device (the flagship reference
    capability, ``euclidiean_reconstruction.py:13-66``). Calibration at
    this scale runs sharded on a trivial 1-device mesh. Returns the cold
    (compile included) and warm walls and the convergence checks."""
    from mvrecon_tpu.config import LMConfig
    from mvrecon_tpu.geometry.scenes import make_synthetic_scene
    from mvrecon_tpu.models.pipelines import euclidean_reconstruction_large
    from mvrecon_tpu.parallel.mesh import make_mesh

    scene = make_synthetic_scene(
        jax.random.key(0), n_images=n_views, n_slices=n_points // 20,
        n_angles=20, dtype=jnp.float32,
    )
    x_fp = scene.x  # (F, P, 2)
    mesh = make_mesh({"points": 1})
    config = LMConfig(
        scale_factor=4.0, delta_tol=0.0, max_iter=ba_iters,
        accept_divisor=1.0, init_damping=3e-3, damping="nielsen",
    )

    def run():
        start = time.perf_counter()
        res = jax.block_until_ready(euclidean_reconstruction_large(
            x_fp, f0=1.0, tol=1e-2, method="dual", config=config,
            chunk_size=chunk, mesh=mesh,
        ))
        return res, time.perf_counter() - start

    _, cold = run()
    res, warm = run()
    err = float(res.error)
    return {
        "points": n_points, "views": n_views, "ba_iters": ba_iters,
        "cold_wall_s": cold,
        "wall_s": warm,
        "calib_status": int(res.status),
        "ba_n_iter": int(res.n_iter),
        "reprojection_error": err,
        "E_vs_noise_floor": err / noise_floor(n_points * n_views),
    }


def bench_covariance(x, res, chunk=768):
    """Uncertainty quantification at the north-star scale: covariance
    blocks of the converged 100k x 1000 state."""
    from functools import partial

    from mvrecon_tpu.models.covariance import ba_covariance_chunked

    cov_fn = jax.jit(partial(
        ba_covariance_chunked, f0=1.0, axis="x-up_z-forward",
        chunk_size=chunk,
    ))

    def run():
        cov = cov_fn(x, res.X, res.K, res.R, res.t)
        sig = jnp.sqrt(jnp.trace(cov.point_cov, axis1=-2, axis2=-1) / 3.0)
        ok = jnp.isfinite(cov.point_cov).all() & jnp.isfinite(cov.camera_cov).all()
        return jax.block_until_ready(
            (jnp.sqrt(cov.sigma2), jnp.median(sig), jnp.max(sig), ok)
        )

    run()
    start = time.perf_counter()
    sigma, med, mx, ok = run()
    wall = time.perf_counter() - start
    assert bool(ok), "covariance produced non-finite blocks"
    return {
        "points": int(x.shape[0]), "views": int(x.shape[1]),
        "wall_s": wall,
        "sigma": float(sigma),
        "point_sigma_median": float(med),
        "point_sigma_max": float(mx),
    }


def _load_script(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "scripts", f"{name}.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bench_bal(n_points=20_000, n_cams=100, vis_frac=0.2, outlier_frac=0.02):
    """Sparse-visibility Huber BA on a BAL-format problem (sequential-
    capture sliding-window visibility + gross outliers); see
    scripts/bench_bal.py for the full proof point."""
    from mvrecon_tpu.config import LMConfig
    from mvrecon_tpu.models.bundle_adjustment import bundle_adjust
    from mvrecon_tpu.ops.procrustes import aligned_rmse
    from mvrecon_tpu.runtime.io import load_bal

    mod = _load_script("bench_bal")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "problem.bal")
        X_gt, _ = mod.make_problem(n_points, n_cams, vis_frac, outlier_frac,
                                   path=path)
        d = load_bal(path)
    n_obs = int(d["visibility"].sum())

    dtype = jnp.float32
    x = jnp.asarray(d["x"].transpose(1, 0, 2), dtype)
    vis = jnp.asarray(d["visibility"], dtype)
    X0, t0 = (jnp.asarray(v, dtype) for v in mod.perturbed_init(d["X"], d["t"]))
    config = LMConfig(
        scale_factor=4.0, delta_tol=1e-4, max_iter=30,
        accept_divisor=1.0, init_damping=3e-3, damping="nielsen",
        robust="huber", huber_delta=0.02,
    )

    def run():
        return jax.block_until_ready(bundle_adjust(
            x, X0, jnp.asarray(d["K"], dtype), jnp.asarray(d["R"], dtype),
            t0, f0=1.0, axis="x-up_z-forward", config=config, visibility=vis,
        ))

    run()
    start = time.perf_counter()
    res = run()
    wall = time.perf_counter() - start
    return {
        "cams": n_cams, "points": n_points, "observations": n_obs,
        "visibility_frac": n_obs / (n_points * n_cams),
        "outlier_frac": outlier_frac,
        "wall_s": wall, "n_iter": int(res.n_iter),
        "aligned_rmse_vs_gt": float(
            aligned_rmse(res.X, jnp.asarray(X_gt, dtype))
        ),
    }


def bench_bal_large(n_points=1_000_000, n_cams=1_600, window=10,
                    max_iter=12, cg_max_iter=40):
    """BAL-class sparse BA: 1M points x 1,600 cameras x 10M observations
    at 0.6% fill via the O(n_obs) observation-list core — a problem no
    dense-mask core can hold (the (P, F, 2) array alone would be 13 GB).
    The problem is generated on the device
    (scripts/bench_sparse_capacity.py::generate) and solved in one
    ``bundle_adjust_sparse`` call."""
    from mvrecon_tpu.config import LMConfig
    from mvrecon_tpu.models.bundle_adjustment_sparse import bundle_adjust_sparse
    from mvrecon_tpu.ops.procrustes import aligned_rmse

    mod = _load_script("bench_sparse_capacity")
    obs, X_gt, X0, K, R, t, t0 = jax.block_until_ready(
        mod.generate(jax.random.key(0), n_points, n_cams, window)
    )
    config = LMConfig(
        scale_factor=4.0, delta_tol=1e-4, max_iter=max_iter,
        accept_divisor=1.0, init_damping=3e-3, damping="nielsen",
        robust="huber", huber_delta=0.02,
    )

    def run():
        return jax.block_until_ready(bundle_adjust_sparse(
            obs, X0, K, R, t0, f0=1.0, axis="x-up_z-forward", config=config,
            cg_tol=1e-2, cg_max_iter=cg_max_iter,
        ))

    run()
    start = time.perf_counter()
    res = run()
    wall = time.perf_counter() - start
    n_iter = int(res.n_iter)
    return {
        "cams": n_cams, "points": int(X_gt.shape[0]),
        "observations": obs.n_obs,
        "fill_frac": obs.n_obs / (X_gt.shape[0] * n_cams),
        "cg_max_iter": cg_max_iter,
        "wall_s": wall,
        "wall_s_per_iter": wall / max(n_iter, 1),
        "n_iter": n_iter,
        "cg_iters_total": int(res.log["cg_iters_total"]),
        "aligned_rmse_vs_gt": float(aligned_rmse(res.X, X_gt)),
    }


def bench_batched(n_scenes=256, n_views=100, ba_iters=15, scene_chunk=64,
                  delta_tol=0.0):
    from mvrecon_tpu.config import LMConfig
    from mvrecon_tpu.geometry.scenes import make_synthetic_scene
    from mvrecon_tpu.parallel.batched import batched_euclidean_reconstruction

    dtype = jnp.float32
    keys = jax.random.split(jax.random.key(0), n_scenes)
    gen = jax.jit(jax.vmap(
        lambda k: make_synthetic_scene(k, n_images=n_views, dtype=dtype).x
    ))
    x = gen(keys)
    # Nielsen gain-ratio damping: fewer rejected retries, and every retry
    # here is a full batched Schur solve.
    config = LMConfig(
        scale_factor=4.0, delta_tol=delta_tol, max_iter=ba_iters,
        accept_divisor=1.0, init_damping=3e-3, damping="nielsen",
    )

    def run():
        return jax.block_until_ready(batched_euclidean_reconstruction(
            x, f0=1.0, tol=1e-2, method="dual", config=config,
            eig_method="lowrank", scene_chunk=scene_chunk,
        ))

    run()
    start = time.perf_counter()
    res = run()
    wall = time.perf_counter() - start
    errs = np.asarray(res.error)
    status = np.asarray(res.status)
    n_iter = np.asarray(res.n_iter)
    return {
        "scenes": n_scenes, "views": n_views, "ba_iters": ba_iters,
        "delta_tol": delta_tol,
        "wall_s": wall,
        "scenes_per_s": n_scenes / wall,
        "calib_ok": int((status == 0).sum()),
        "finite": int(np.isfinite(errs).sum()),
        "converged_early": int((n_iter < ba_iters).sum()),
        "n_iter_max": int(n_iter.max()),
        "worst_E_vs_noise_floor": float(
            np.nanmax(errs) / noise_floor(200 * n_views)
        ),
    }


def headline_record(rec):
    """metric/value/vs_baseline from a headline record."""
    shape = (rec["points"], rec["views"])
    ref = REFERENCE_CPU_WALL.get(shape)
    wall = rec["wall_s"]
    return {
        "metric": f"ba_{shape[0]}pts_{shape[1]}views_{rec['iters']}iter_wall",
        "value": wall,
        "unit": "s",
        "vs_baseline": ref / wall if ref else 0.0,
    }


def _batched_converged():
    # run-to-convergence variant (the reference stopping contract,
    # lib/bundle_adjustment.py:186-191): per-scene early exit at
    # |dE| <= 1e-3, budget 40 — scenes/s-to-noise-floor
    return bench_batched(ba_iters=40, delta_tol=1e-3)


FIELDS = {
    "northstar_pipeline": bench_northstar_pipeline,
    "bal_large_sparse": bench_bal_large,
    "bal_sparse": bench_bal,
    "batched": bench_batched,
    "batched_converged": _batched_converged,
}


def main():
    device = gpu_info()
    from mvrecon_tpu.runtime.cache import enable_compilation_cache

    enable_compilation_cache()
    only = os.environ.get("MVRECON_BENCH_ONLY")
    only = {s.strip() for s in only.split(",")} if only else None

    rec = bench_headline()
    out = {**headline_record(rec), "device": device, "headline": rec}
    if only is None or only & {"northstar", "covariance"}:
        # covariance runs at the northstar optimum, so the two share a run
        out["northstar"], (x, res) = bench_northstar()
        out["covariance"] = bench_covariance(x, res)
        del x, res
    for field, fn in FIELDS.items():
        if only is None or field in only:
            out[field] = fn()
    sys.stdout.write(json.dumps(out) + "\n")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
