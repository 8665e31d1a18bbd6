"""Smoke run of the reconstruction system on an NVIDIA GPU.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # point-sharded BA over four cards

One card runs these phases, in this order, in this one process:

- device: require JAX's GPU backend; print the device, the jax/jaxlib
  versions, XLA_FLAGS and nvidia-smi's card name and power limit;
- pipeline: ``euclidean_reconstruction_large`` at 100,000 points x
  1,000 views (bench.py's northstar_pipeline call): calibration status
  0 and E within 1.05x the noise floor;
- reference: at 10,000 points x 100 views, the chunked core's reduced
  camera system (A, b), built on the card in float32 at HIGHEST, against
  the dense core's system built in float64 on the host CPU backend; then
  10 LM iterations of the dense and the chunked core on the card must
  agree in E;
- cli: ``mvrecon_tpu bal --sparse --huber`` (in-process) on a BAL file
  of 100 cameras x 20,000 points with sliding-window visibility and 2%
  gross outliers: finite error, inlier reprojection RMSE at the noise;
- kernels: the lower-triangle SYRK kernel (Pallas, Triton route) against
  the XLA einsum at the 100k x 1000 chunk shape, both at HIGHEST;
- cache: with ``JAX_COMPILATION_CACHE_DIR`` set, entries exist there.

``--four-cards`` runs only point-sharded BA over a 4-device points mesh
at 100,000 x 1,000 (``sharded_bundle_adjust`` and
``sharded_bundle_adjust_chunked``) and the one-card
``bundle_adjust_chunked`` on the same problem; all must reach the noise
floor, and each sharded E must agree with the one-card E.

Every line before the last is one JSON object. The last line is
``{"ok": true, "device": {...}}``; a failed check raises, so the script
exits non-zero without it.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

import jax
import jax.numpy as jnp

E_FLOOR_RATIO = 1.05  # converged E over the noise floor
SYSTEM_RTOL = 1e-4  # chunked f32 HIGHEST system vs dense float64
LM_AGREE_RTOL = 1e-3  # dense vs chunked E after 10 LM iterations
SHARDED_AGREE_RTOL = 1e-2  # 4-card sharded vs 1-card chunked E
CLI_RMSE_RATIO = 1.2  # inlier reprojection RMSE over the pixel noise
SYRK_RTOL = 1e-6  # SYRK kernel vs einsum, both float32 at HIGHEST
NOISE = 0.005


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, what: str, **fields) -> None:
    if not cond:
        raise CheckFailed(f"{what}: {json.dumps(fields, default=str)}")


def ok_line(device: dict) -> str:
    """The contract's last line."""
    return json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"],
    }})


def device_phase() -> dict:
    """Require the GPU backend; print what runs. Exits non-zero on a
    machine without one (no fallback to the CPU)."""
    devs = jax.devices()
    backend = jax.default_backend()
    if backend != "gpu" or not devs:
        sys.exit(f"chip_smoke: needs a GPU backend, found {backend!r}")
    import jaxlib

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    check(bool(smi), "nvidia-smi printed nothing")
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs)}
    log("device", **device, jax=jax.__version__, jaxlib=jaxlib.__version__,
        xla_flags=os.environ.get("XLA_FLAGS", ""))
    print(smi, flush=True)
    return device


def pipeline_phase(n_points=100_000, n_views=1000, chunk=768) -> dict:
    import bench

    rec = bench.bench_northstar_pipeline(n_points, n_views, chunk=chunk)
    log("pipeline", **rec)
    check(rec["calib_status"] == 0, "calibration status", **rec)
    check(bool(np.isfinite(rec["reprojection_error"]))
          and rec["E_vs_noise_floor"] <= E_FLOOR_RATIO,
          "pipeline E vs noise floor", **rec)
    return rec


def _normalized_state(x, X0, K, R, t0, axis="x-up_z-forward"):
    from mvrecon_tpu.models.bundle_adjustment import (
        BAState, gauge_mask, intrinsics_from_K, normalize_gauge,
    )

    X, Rn, t, _ = normalize_gauge(X0, R, t0, axis)
    f, u = intrinsics_from_K(K, 1.0)
    free = gauge_mask(x.shape[1], axis, x.dtype)
    return BAState(X=X, f=f, u=u, t=t, R=Rn), free


def chunked_system(x, state, free, c, chunk):
    """(A, b) of the chunked core's build scan (full visibility)."""
    from mvrecon_tpu.models.bundle_adjustment_chunked import (
        _build_system, chunk_points,
    )

    vis = jnp.ones((x.shape[0], 1), x.dtype)
    x_ch, vis_ch, X_ch = chunk_points(x, vis, state.X, chunk)
    cam = state._replace(X=jnp.zeros((0, 3), x.dtype))
    a, b, _, _ = _build_system(cam, X_ch, x_ch, vis_ch, free, 1.0, c)
    return a, b * free


def dense_system(x, state, free, c):
    """(A, b) of the dense core: its derivative blocks and its Schur
    assembly (``_compute_derivs`` + ``reduced_camera_system``)."""
    from mvrecon_tpu.models.bundle_adjustment import (
        _compute_derivs, reduced_camera_system,
    )

    vis = jnp.ones(x.shape[:2], x.dtype)
    derivs, _ = _compute_derivs(state, x, vis, free, 1.0)
    matEc = derivs.matE * (1.0 + c * jnp.eye(3, dtype=x.dtype))
    matGc = derivs.matG * (1.0 + c * jnp.eye(9, dtype=x.dtype))
    a, b, _ = reduced_camera_system(derivs, matEc, matGc, free)
    return a, b * free


def system_errors(n_points, n_views, chunk=768, c=1e-2) -> dict:
    """Relative errors of the chunked float32 (A, b) on the default
    device against the dense float64 (A, b) on the host CPU backend,
    both built from the same float32 inputs."""
    import bench

    x, X0, K, R, t0 = bench.build_problem(n_points, n_views)
    state, free = _normalized_state(x, X0, K, R, t0)
    a32, b32 = jax.block_until_ready(jax.jit(
        lambda x, s, fr: chunked_system(x, s, fr, c, chunk))(x, state, free))
    host = jax.tree.map(lambda v: np.asarray(v, np.float64), (x, state, free))
    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        a64, b64 = jax.jit(lambda x, s, fr: dense_system(x, s, fr, c))(*host)
        a64, b64 = np.asarray(a64), np.asarray(b64)
    a32, b32 = np.asarray(a32, np.float64), np.asarray(b32, np.float64)
    return {
        "A_rel_fro_err": float(np.linalg.norm(a32 - a64) / np.linalg.norm(a64)),
        "b_rel_err": float(np.linalg.norm(b32 - b64) / np.linalg.norm(b64)),
    }


def lm_agreement(n_points, n_views, iters=10, chunk=768) -> dict:
    """Final E of ``iters`` LM iterations of the dense and the chunked
    core on the same problem and config."""
    import bench
    from mvrecon_tpu.config import LMConfig
    from mvrecon_tpu.models.bundle_adjustment import bundle_adjust
    from mvrecon_tpu.models.bundle_adjustment_chunked import bundle_adjust_chunked

    x, X0, K, R, t0 = bench.build_problem(n_points, n_views)
    config = LMConfig(scale_factor=2.0, delta_tol=0.0, max_iter=iters)
    kw = dict(f0=1.0, axis="x-up_z-forward", config=config)
    dense = bundle_adjust(x, X0, K, R, t0, **kw)
    chunked = bundle_adjust_chunked(x, X0, K, R, t0, chunk_size=chunk, **kw)
    e_d, e_c = float(dense.error), float(chunked.error)
    return {"E_dense": e_d, "E_chunked": e_c,
            "rel_diff": abs(e_d - e_c) / abs(e_d),
            "retries_dense": int(dense.log["n_solver_retries"]),
            "retries_chunked": int(chunked.log["n_solver_retries"])}


def reference_phase(n_points=10_000, n_views=100, chunk=768) -> dict:
    t = time.perf_counter()
    errs = system_errors(n_points, n_views, chunk)
    rec = {**errs, "precision": "float32 HIGHEST vs float64",
           "tolerance": SYSTEM_RTOL, "points": n_points, "views": n_views,
           "wall_s": time.perf_counter() - t}
    log("reference_system", **rec)
    check(errs["A_rel_fro_err"] <= SYSTEM_RTOL
          and errs["b_rel_err"] <= SYSTEM_RTOL, "chunked vs dense system", **rec)
    t = time.perf_counter()
    agree = lm_agreement(n_points, n_views, chunk=chunk)
    rec2 = {**agree, "tolerance": LM_AGREE_RTOL,
            "wall_s": time.perf_counter() - t}
    log("reference_lm", **rec2)
    check(np.isfinite(agree["E_dense"]) and agree["rel_diff"] <= LM_AGREE_RTOL,
          "dense vs chunked LM", **rec2)
    return {**rec, **rec2}


def inlier_rmse(bal_path, inlier) -> float:
    """Per-coordinate reprojection RMSE of a solved BAL file over the
    inlier observations. BA also fits each camera's principal point,
    which a BAL file cannot hold; it only shifts that camera's image, so
    each camera's median inlier residual is taken out first."""
    from mvrecon_tpu.models.bundle_adjustment import calc_pqr
    from mvrecon_tpu.runtime.io import load_bal_sparse

    d = load_bal_sparse(bal_path)
    _, p, q, r = calc_pqr(*(jnp.asarray(d[k], jnp.float32)
                            for k in ("X", "K", "R", "t")))
    pi, ci = d["point_idx"][inlier], d["cam_idx"][inlier]
    p, q, r = (np.asarray(v)[pi, ci] for v in (p, q, r))
    res = np.stack([p / r, q / r], -1) - d["xy"][inlier]
    for cam in np.unique(ci):
        sel = ci == cam
        res[sel] -= np.median(res[sel], axis=0)
    return float(np.sqrt(np.mean(res**2)))


def cli_phase(n_points=20_000, n_cams=100) -> dict:
    """bench.py's bal_sparse problem (scripts/bench_bal.py, 20% sliding-
    window visibility, 2% gross outliers), written with its perturbed
    start and solved by the CLI."""
    import bench
    from mvrecon_tpu.cli import main as cli_main

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "problem.bal")
        dst = os.path.join(tmp, "solved.bal")
        _, inlier = bench._load_script("bench_bal").make_problem(
            n_points, n_cams, 0.2, 0.02, path=src, perturbed=True)
        argv = ["bal", src, "--sparse", "--huber", "0.02", "--max-iter", "30",
                "--delta-tol", "1e-4", "--scale-factor", "4",
                "--ignore-distortion", "--output-bal", dst]
        out = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            cli_main(argv)
        wall = time.perf_counter() - t
        rec = json.loads(out.getvalue().strip().splitlines()[-1])
        rmse = inlier_rmse(dst, inlier)
    summary = {k: rec[k] for k in ("cams", "points", "observations",
                                   "ba_iterations", "cg_iterations",
                                   "reprojection_error")}
    summary.update(wall_s=wall, inlier_rmse=rmse,
                   rmse_vs_noise=rmse / NOISE, tolerance=CLI_RMSE_RATIO)
    log("cli", **summary)
    check(bool(np.isfinite(rec["reprojection_error"]))
          and rmse / NOISE <= CLI_RMSE_RATIO, "CLI sparse BAL run", **summary)
    return summary


def kernels_phase(k_dim=2304, n_dim=9000, reps=10) -> dict:
    """The lower-triangle SYRK kernel (ops/pallas_syrk.py, Triton route)
    against the XLA einsum at the chunk shape of 100k x 1000 (3 x 768
    rows, 9 x 1000 columns): float32 operands at HIGHEST (IEEE products,
    no TF32) with float32 accumulation on both sides."""
    from mvrecon_tpu.ops.pallas_syrk import syrk

    hi = jax.lax.Precision.HIGHEST
    y = jax.random.normal(jax.random.key(0), (k_dim, n_dim), jnp.float32)
    einsum = jax.jit(lambda y: jnp.einsum("km,kn->mn", y, y, precision=hi))

    def median_ms(fn):
        jax.block_until_ready(fn(y))
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            jax.block_until_ready(fn(y))
            times.append(time.perf_counter() - t)
        return 1e3 * float(np.median(times))

    want, got = einsum(y), syrk(y, hi)
    err = float(jnp.linalg.norm(got - want) / jnp.linalg.norm(want))
    rec = {"kernel": "syrk_lower (pallas, triton)", "K": k_dim, "N": n_dim,
           "precision": "float32 operands at HIGHEST, float32 accumulation",
           "rel_fro_err_vs_einsum": err, "tolerance": SYRK_RTOL,
           "kernel_ms": median_ms(lambda y: syrk(y, hi)),
           "einsum_ms": median_ms(einsum)}
    log("kernels", **rec)
    check(bool(np.isfinite(err)) and err <= SYRK_RTOL, "SYRK kernel vs einsum",
          **rec)
    return rec


def cache_phase() -> dict:
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    path = jax.config.jax_compilation_cache_dir
    n = len(os.listdir(path)) if path and os.path.isdir(path) else 0
    rec = {"env": env, "cache_dir": path, "entries": n}
    log("cache", **rec)
    if env:
        check(os.path.abspath(path) == os.path.abspath(env) and n > 0,
              "compile cache in JAX_COMPILATION_CACHE_DIR", **rec)
    return rec


def four_cards_phase(n_points=100_000, n_views=1000, chunk=768) -> dict:
    """Point-sharded BA over 4 devices, dense per shard
    (``sharded_bundle_adjust``) and chunked per shard
    (``sharded_bundle_adjust_chunked``, whose float32 build runs the SYRK
    kernel inside shard_map), each against the one-device chunked core."""
    import bench
    from mvrecon_tpu.config import LMConfig
    from mvrecon_tpu.models.bundle_adjustment_chunked import bundle_adjust_chunked
    from mvrecon_tpu.parallel.mesh import make_mesh
    from mvrecon_tpu.parallel.sharded_ba import (
        sharded_bundle_adjust, sharded_bundle_adjust_chunked,
    )

    check(len(jax.devices()) >= 4, "four devices", n=len(jax.devices()))
    x, X0, K, R, t0 = bench.build_problem(n_points, n_views)
    config = LMConfig(scale_factor=4.0, delta_tol=0.0, max_iter=10,
                      accept_divisor=1.0, init_damping=1e-2, damping="nielsen")
    kw = dict(f0=1.0, axis="x-up_z-forward", config=config)
    mesh = make_mesh({"points": 4})
    runs = {
        "sharded_4": lambda: sharded_bundle_adjust(mesh, x, X0, K, R, t0, **kw),
        "sharded_chunked_4": lambda: sharded_bundle_adjust_chunked(
            mesh, x, X0, K, R, t0, chunk_size=chunk, **kw),
        "chunked_1": lambda: bundle_adjust_chunked(
            x, X0, K, R, t0, chunk_size=chunk, **kw),
    }
    floor = bench.noise_floor(x.shape[0] * n_views)
    rec = {"points": int(x.shape[0]), "views": n_views}
    for name, run in runs.items():
        t = time.perf_counter()
        res = jax.block_until_ready(run())
        rec[f"cold_wall_s_{name}"] = time.perf_counter() - t
        rec[f"E_{name}"] = float(res.error)
        rec[f"E_{name}_vs_floor"] = rec[f"E_{name}"] / floor
        rec[f"retries_{name}"] = int(res.log["n_solver_retries"])
    e_one = rec["E_chunked_1"]
    for name in ("sharded_4", "sharded_chunked_4"):
        rec[f"rel_diff_{name}"] = abs(rec[f"E_{name}"] - e_one) / abs(e_one)
    log("four_cards", **rec)
    check(all(rec[f"E_{n}_vs_floor"] <= E_FLOOR_RATIO for n in runs)
          and rec["rel_diff_sharded_4"] <= SHARDED_AGREE_RTOL
          and rec["rel_diff_sharded_chunked_4"] <= SHARDED_AGREE_RTOL,
          "sharded vs one-card BA", **rec)
    return rec


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the 4-card point-sharded BA phase")
    args = parser.parse_args(argv)

    device = device_phase()
    from mvrecon_tpu.runtime.cache import enable_compilation_cache

    enable_compilation_cache()
    if args.four_cards:
        four_cards_phase()
    else:
        pipeline_phase()
        reference_phase()
        cli_phase()
        kernels_phase()
        cache_phase()
    print(ok_line(device), flush=True)


if __name__ == "__main__":
    main()
