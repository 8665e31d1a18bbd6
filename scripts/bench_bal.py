"""BAL-style ragged-visibility proof point.

Generates a realistic sparse-track bundle-adjustment problem in the
standard BAL text format (Agarwal et al., ECCV 2010) — sliding-window
visibility (each point seen only by a consecutive camera window, as in
real sequential capture), pixel noise, a fraction of gross outliers, and
a perturbed initialization — then ingests it through ``runtime.io.load_bal``
and runs Huber-robust BA with the sparse visibility mask. This exercises
the visibility path at realistic sparsity (the synthetic suite's masks
are dense-ish) and the robust loss against real outliers.

Usage: python scripts/bench_bal.py [n_points] [n_cams] [vis_frac]
           [outlier_frac] [iters] [distort 0|1] [chunk_size]
``distort 1`` renders through a shared BAL radial (k1, k2) = (-0.3,
0.05) and recovers it from zero with the tied closed-form refit
(distortion_rounds=2, full 9-parameter BAL camera). ``chunk_size > 0``
runs the O(chunk)-memory core. Writes/reads mvrecon_bal_problem.txt
under the temporary directory; prints one JSON line.
"""

import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, ".")

from mvrecon_tpu.runtime.cache import enable_compilation_cache

enable_compilation_cache()

import jax
import jax.numpy as jnp

from mvrecon_tpu.config import LMConfig
from mvrecon_tpu.geometry.camera import project_points
from mvrecon_tpu.geometry.scenes import make_synthetic_scene
from mvrecon_tpu.models.bundle_adjustment import bundle_adjust
from mvrecon_tpu.ops.procrustes import aligned_rmse
from mvrecon_tpu.runtime.io import load_bal, save_bal_sparse

PATH = os.path.join(tempfile.gettempdir(), "mvrecon_bal_problem.txt")


K_TRUE = (-0.3, 0.05)  # shared radial distortion of the distorted variant


def perturbed_init(X, t, seed=1):
    """The solvers' start: ground-truth X and t plus 0.05 Gaussian noise
    (BAL inits are noisy; ours is ground truth + noise)."""
    rng = np.random.default_rng(seed)
    return (X + 0.05 * rng.standard_normal(X.shape),
            t + 0.05 * rng.standard_normal(t.shape))


def make_problem(n_points, n_cams, vis_frac, outlier_frac, seed=0,
                 distort=False, path=PATH, perturbed=False):
    """Sequential-capture scene: window visibility + noise + outliers;
    with ``distort`` the observations render through a shared BAL radial
    (k1, k2) (one physical camera), saved in the BAL file. The file holds
    the ground-truth X and t, or with ``perturbed`` the start of
    :func:`perturbed_init`, for solvers that start from the file (the
    CLI). Returns the ground-truth X and the inlier mask over the
    point-sorted observations (the order of ``load_bal_sparse``)."""
    sc = make_synthetic_scene(
        jax.random.key(seed), n_images=n_cams, n_slices=n_points // 20,
        n_angles=20, noise=0.0, dtype=jnp.float64,
    )
    x = np.asarray(sc.x)  # (F, P, 2) noise-free
    dist = None
    if distort:
        from mvrecon_tpu.models.bundle_adjustment import (
            BAState, _distortion_terms, build_K, calc_pqr,
        )

        dist = np.broadcast_to(np.asarray(K_TRUE), (n_cams, 2))
        st = BAState(X=sc.X, f=sc.K[:, 0, 0], u=sc.K[:, :2, 2],
                     t=sc.t, R=sc.R)
        _, p, q, r = calc_pqr(st.X, build_K(st.f, st.u, 1.0), st.R, st.t)
        g1, g2, _, d, _ = _distortion_terms(st, p, q, r, 1.0,
                                            jnp.asarray(dist))
        x = np.stack(
            [np.asarray(d * g1) + np.asarray(st.u[:, 0])[None],
             np.asarray(d * g2) + np.asarray(st.u[:, 1])[None]], -1,
        ).transpose(1, 0, 2)  # (F, P, 2)
    rng = np.random.default_rng(seed)

    # sliding window: point p is visible in a window of ~vis_frac * F
    # consecutive cameras centred at a point-dependent position
    window = max(2, int(vis_frac * n_cams))
    centers = rng.integers(0, n_cams, n_points)
    lo = np.clip(centers - window // 2, 0, n_cams - window)
    cams = np.arange(n_cams)
    vis = ((cams[None, :] >= lo[:, None]) & (cams[None, :] < (lo + window)[:, None]))

    x = x + 0.005 * rng.standard_normal(x.shape)  # pixel noise
    pi, ci = np.nonzero(vis)  # point-sorted observations
    n_out = int(outlier_frac * len(pi))
    pick = rng.choice(len(pi), n_out, replace=False)
    x[ci[pick], pi[pick]] += rng.standard_normal((n_out, 2)) * 0.5  # gross outliers
    inlier = np.ones(len(pi), bool)
    inlier[pick] = False

    X, t = np.asarray(sc.X), np.asarray(sc.t)
    X_file, t_file = perturbed_init(X, t) if perturbed else (X, t)
    save_bal_sparse(
        path, pi, ci, x[ci, pi], n_points, X_file, np.asarray(sc.R), t_file,
        np.asarray(sc.K[:, 0, 0]), distortion=dist,
    )
    return X, inlier


def main():
    n_points = int(sys.argv[1]) if len(sys.argv) > 1 else 20_000
    n_cams = int(sys.argv[2]) if len(sys.argv) > 2 else 100
    vis_frac = float(sys.argv[3]) if len(sys.argv) > 3 else 0.2
    outlier_frac = float(sys.argv[4]) if len(sys.argv) > 4 else 0.02
    iters = int(sys.argv[5]) if len(sys.argv) > 5 else 30
    distort = len(sys.argv) > 6 and sys.argv[6] == "1"
    chunk = int(sys.argv[7]) if len(sys.argv) > 7 else 0

    X_gt, _ = make_problem(n_points, n_cams, vis_frac, outlier_frac,
                           distort=distort)
    d = load_bal(PATH)
    n_obs = int(d["visibility"].sum())
    print(
        f"BAL problem: {n_cams} cams, {n_points} pts, {n_obs} observations "
        f"({n_obs / (n_points * n_cams):.1%} visibility)", flush=True,
    )

    dtype = jnp.float32
    x = jnp.asarray(d["x"].transpose(1, 0, 2), dtype)  # (P, F, 2)
    vis = jnp.asarray(d["visibility"], dtype)
    X0, t0 = (jnp.asarray(v, dtype) for v in perturbed_init(d["X"], d["t"]))
    K0 = jnp.asarray(d["K"], dtype)
    R0 = jnp.asarray(d["R"], dtype)

    config = LMConfig(
        scale_factor=4.0, delta_tol=1e-4, max_iter=iters,
        accept_divisor=1.0, init_damping=3e-3, damping="nielsen",
        robust="huber", huber_delta=0.02,
        # distorted variant: recover the shared k from zero with the
        # closed-form tied refit (full 9-parameter BAL camera)
        distortion_rounds=2 if distort else 0,
        distortion_shared=True,
    )
    if chunk > 0:
        import functools

        from mvrecon_tpu.models.bundle_adjustment_chunked import (
            bundle_adjust_chunked,
        )

        ba_fn = functools.partial(bundle_adjust_chunked, chunk_size=chunk)
    else:
        ba_fn = bundle_adjust

    def run():
        res = ba_fn(
            x, X0, K0, R0, t0, f0=1.0, axis="x-up_z-forward",
            config=config, visibility=vis,
        )
        err = float(res.error)
        jax.block_until_ready(res)
        return res, err

    res, err = run()  # compile
    t0_ = time.perf_counter()
    res, err = run()
    wall = time.perf_counter() - t0_

    rmse = float(aligned_rmse(res.X, jnp.asarray(X_gt, dtype)))
    # inlier noise floor: Huber-weighted E of noise-only residuals ~ n_inlier*2*sigma^2
    floor = (1 - outlier_frac) * n_obs * 2 * 0.005**2
    out = {
        "metric": "bal_huber_ba",
        "cams": n_cams, "points": n_points, "observations": n_obs,
        "visibility_frac": round(n_obs / (n_points * n_cams), 4),
        "outlier_frac": outlier_frac,
        "wall_s": round(wall, 3),
        "n_iter": int(res.n_iter),
        "robust_E": err,
        "E_vs_inlier_floor": round(err / floor, 3),
        "aligned_rmse_vs_gt": rmse,
    }
    if chunk > 0:
        out["chunk_size"] = chunk
    if distort:
        k = np.asarray(res.distortion)
        out.update(
            k1_recovered=round(float(k[0, 0]), 4), k1_true=K_TRUE[0],
            k2_recovered=round(float(k[0, 1]), 4), k2_true=K_TRUE[1],
        )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
