"""Unified command-line interface.

The reference is driven by editing two demo scripts (SURVEY.md §5: no
config/flag system); here every pipeline is reachable headlessly:

    python -m mvrecon_tpu euclidean --n-images 10 --method dual
    python -m mvrecon_tpu affine --model paraperspective --n-images 12
    python -m mvrecon_tpu batch --scenes 16 --n-images 20
    python -m mvrecon_tpu bench-ba --points 2000 --views 50

All knobs of the pipelines (tolerances, LM hyperparameters, scene size,
precision, dtype) are flags; results print as one JSON object.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np


def _common(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--seed", type=int, default=123)
    parser.add_argument("--noise", type=float, default=0.005)
    parser.add_argument("--f", type=float, default=1.0, help="focal length")
    parser.add_argument("--f0", type=float, default=1.0)
    parser.add_argument("--max-iter", type=int, default=100)
    parser.add_argument("--delta-tol", type=float, default=1e-8)
    parser.add_argument("--scale-factor", type=float, default=2.0)
    parser.add_argument("--float64", action="store_true", help="run in float64")
    parser.add_argument("--viz", action="store_true", help="show plots")
    parser.add_argument("--log-json", type=str, default=None,
                        help="append convergence records to this JSONL file")
    parser.add_argument("--profile", type=str, default=None, metavar="DIR",
                        help="capture a device trace to DIR (TensorBoard/Perfetto)")
    parser.add_argument("--platform", choices=["default", "cpu", "gpu"],
                        default=None,
                        help="force a jax platform before backend init "
                        "(applied with jax.config.update, so it also holds "
                        "when jax was imported first); default: "
                        "MVRECON_PLATFORM env or jax's own choice")
    parser.add_argument("--num-cpu-devices", type=int, default=None,
                        help="virtual CPU device count (for --platform cpu "
                        "with --shard-points)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="mvrecon_tpu")
    sub = parser.add_subparsers(dest="command", required=True)

    shard_help = (
        "shard the points axis over N devices (points mesh; calibration + "
        "BA run end-to-end sharded; P must be divisible by N)"
    )
    p_eucl = sub.add_parser("euclidean", help="perspective self-calibration + BA")
    p_eucl.add_argument("--shard-points", type=int, default=0, metavar="N",
                        help=shard_help)
    _common(p_eucl)
    p_eucl.add_argument("--n-images", type=int, default=10)
    p_eucl.add_argument("--method", choices=["primary", "dual"], default="dual")
    p_eucl.add_argument("--tol", type=float, default=1e-2)
    p_eucl.add_argument("--eig-method", choices=["eigh", "lowrank", "power"], default="eigh")

    p_aff = sub.add_parser("affine", help="affine self-calibration + BA")
    p_aff.add_argument("--shard-points", type=int, default=0, metavar="N",
                       help=shard_help)
    _common(p_aff)
    p_aff.add_argument("--n-images", type=int, default=12)
    p_aff.add_argument(
        "--model",
        choices=["orthographic", "symmetric", "paraperspective"],
        default="paraperspective",
    )

    p_batch = sub.add_parser("batch", help="vmap-batched euclidean reconstruction")
    _common(p_batch)
    p_batch.add_argument("--scenes", type=int, default=8)
    p_batch.add_argument("--n-images", type=int, default=10)
    p_batch.add_argument("--method", choices=["primary", "dual"], default="dual")
    p_batch.add_argument("--tol", type=float, default=1e-2)
    p_batch.add_argument("--eig-method", choices=["eigh", "lowrank", "power"], default="eigh")
    p_batch.add_argument("--scene-chunk", type=int, default=None)

    p_rec = sub.add_parser(
        "reconstruct", help="reconstruct from tracked features in an .npz file"
    )
    _common(p_rec)
    p_rec.add_argument("input", type=str, help=".npz with x (F, P, 2) [+ visibility, f, X_gt]")
    p_rec.add_argument("--shard-points", type=int, default=0, metavar="N",
                       help=shard_help + " (euclidean pipeline only)")
    p_rec.add_argument("--output", type=str, default=None, help="write result .npz here")
    p_rec.add_argument(
        "--output-ply", type=str, default=None, metavar="FILE",
        help="write the reconstructed point cloud (+ camera centers) as PLY",
    )
    p_rec.add_argument(
        "--pipeline", choices=["euclidean", "affine"], default="euclidean"
    )
    p_rec.add_argument(
        "--covariance", action="store_true",
        help="estimate per-point/per-camera covariance blocks at the BA "
             "optimum (summary in JSON, full blocks in --output npz, "
             "per-point sigma into --output-ply)",
    )
    p_rec.add_argument("--method", choices=["primary", "dual"], default="dual")
    p_rec.add_argument("--tol", type=float, default=1e-2)
    p_rec.add_argument(
        "--model",
        choices=["orthographic", "symmetric", "paraperspective"],
        default="paraperspective",
    )

    p_bal = sub.add_parser(
        "bal", help="bundle-adjust a BAL problem file or COLMAP text model"
    )
    _common(p_bal)
    p_bal.add_argument(
        "input", type=str,
        help="BAL text file (Agarwal et al. ECCV 2010 format), or a "
             "directory holding a COLMAP text model "
             "(cameras.txt/images.txt/points3D.txt)",
    )
    p_bal.add_argument("--output", type=str, default=None,
                       help="write result .npz here")
    p_bal.add_argument(
        "--output-colmap", type=str, default=None, metavar="DIR",
        help="write the refined model back as a COLMAP text model "
             "(positive-depth models, e.g. COLMAP input)",
    )
    p_bal.add_argument(
        "--output-bal", type=str, default=None, metavar="FILE",
        help="write the refined problem back in BAL format",
    )
    p_bal.add_argument(
        "--output-colmap-pinhole", type=str, default=None, metavar="DIR",
        help="write an *undistorted* SIMPLE_PINHOLE COLMAP model: the "
             "refined geometry with observations mapped through the "
             "exact inverse of the distortion chain (the "
             "image_undistorter workflow pinhole-only consumers, e.g. "
             "NeRF/3DGS pipelines, expect)",
    )
    p_bal.add_argument(
        "--output-ply", type=str, default=None, metavar="FILE",
        help="write the refined point cloud (+ camera centers) as PLY",
    )
    p_bal.add_argument(
        "--huber", type=float, default=None, metavar="DELTA",
        help="robust IRLS with this scale (f0-normalized residual "
             "magnitude); loss kind from --robust-loss",
    )
    p_bal.add_argument(
        "--robust-loss", choices=["huber", "cauchy", "soft_l1", "arctan"],
        default="huber",
        help="IRLS loss family used when --huber is set",
    )
    p_bal.add_argument(
        "--optimize-distortion", type=int, default=0, metavar="R",
        help="alternate R closed-form (k1, k2) refits with the geometry LM",
    )
    p_bal.add_argument(
        "--shared-k", action="store_true",
        help="tie (k1, k2) across all cameras during the refit "
             "(single physical camera)",
    )
    p_bal.add_argument(
        "--tangential", action="store_true",
        help="fit the 4-parameter OPENCV model (k1, k2, p1, p2) during "
             "--optimize-distortion even if the input is radial-only",
    )
    p_bal.add_argument(
        "--ignore-distortion", action="store_true",
        help="pinhole model: drop the file's k1/k2",
    )
    p_bal.add_argument(
        "--covariance", action="store_true",
        help="estimate per-point (3x3) and per-camera (9x9) covariance "
             "blocks at the optimum (Schur-based; chunked when "
             "--chunk-size is set); summary in the JSON record, full "
             "blocks in the --output npz",
    )
    p_bal.add_argument(
        "--damping", choices=["reference", "nielsen"], default="nielsen",
    )
    p_bal.add_argument(
        "--chunk-size", type=int, default=0, metavar="C",
        help="stream points through the O(chunk)-memory LM core in "
             "chunks of C (for problems too large for the dense core)",
    )
    p_bal.add_argument(
        "--shard-points", type=int, default=0, metavar="N",
        help="shard the points axis over N devices (dense core, or the "
             "chunk-streamed core when combined with --chunk-size)",
    )
    p_bal.add_argument(
        "--sparse", action="store_true",
        help="O(n_observations)-memory observation-list core (for "
             "BAL-class sparsity, <1%% fill, where the dense (P, F) "
             "layout cannot hold the problem); composes with "
             "--shard-points, --huber, --optimize-distortion. Outputs: "
             "--output-ply / --output-bal",
    )
    p_bal.add_argument(
        "--cg-max-iter", type=int, default=100, metavar="K",
        help="(--sparse) CG iteration cap of the matrix-free camera "
             "step",
    )
    p_bal.add_argument(
        "--bf16-factors", action="store_true",
        help="(--sparse) store the per-observation Jacobian factor rows "
             "in bfloat16 — ~1.6x single-chip observation capacity; the "
             "LM steps solve a slightly perturbed system but acceptance "
             "is judged at full precision",
    )
    p_bal.add_argument(
        "--recompute-factors", action="store_true",
        help="(--sparse) never store the factor rows: rematerialize "
             "them inside every pass — per-observation residency drops "
             "to the observation list itself (hundreds of millions of "
             "observations on one chip) at ~2x factor FLOPs per CG "
             "iteration",
    )
    p_bal.add_argument(
        "--triangulate-init", action="store_true",
        help="(--sparse) ignore the file's 3D points and initialize by "
             "observation-list DLT triangulation through the file's "
             "cameras (for BAL files whose points are absent or "
             "untrusted; distortion is ignored at init and absorbed by "
             "the LM refinement)",
    )

    p_bench = sub.add_parser("bench-ba", help="time bundle adjustment")
    _common(p_bench)
    p_bench.add_argument("--points", type=int, default=2000)
    p_bench.add_argument("--views", type=int, default=50)
    p_bench.add_argument("--iters", type=int, default=10)
    p_bench.add_argument("--chunked", action="store_true")
    p_bench.add_argument("--chunk-size", type=int, default=4096)

    return parser


def _cmd_bal_sparse(args, out: dict, dtype) -> None:
    """``bal --sparse``: the O(n_obs) observation-list pipeline — load
    straight into triples (dense arrays never materialize), optimize
    with the matrix-free CG core, write PLY/BAL from the triples."""
    import os

    import numpy as np
    import jax.numpy as jnp

    from .config import LMConfig
    from .runtime.io import load_bal_sparse, save_bal_sparse, save_ply

    if os.path.isdir(args.input):
        raise SystemExit(
            "--sparse reads BAL files; COLMAP models load dense "
            "(drop --sparse or convert with save_bal first)"
        )
    d = load_bal_sparse(args.input)
    npts, nf = int(d["n_points"]), int(d["n_cameras"])
    cfg = LMConfig(
        scale_factor=args.scale_factor,
        delta_tol=args.delta_tol,
        max_iter=args.max_iter,
        damping=args.damping,
        robust=args.robust_loss if args.huber is not None else None,
        huber_delta=args.huber if args.huber is not None else 0.05,
        distortion_rounds=args.optimize_distortion,
        distortion_shared=args.shared_k,
    )
    dist = (
        None if args.ignore_distortion
        else jnp.asarray(d["distortion"], dtype)
    )
    K0 = jnp.asarray(d["K"], dtype)
    R0 = jnp.asarray(d["R"], dtype)
    t0 = jnp.asarray(d["t"], dtype)
    if args.triangulate_init:
        from .ops.triangulation import triangulate_sparse

        X0 = triangulate_sparse(
            jnp.asarray(d["point_idx"], jnp.int32),
            jnp.asarray(d["cam_idx"], jnp.int32),
            jnp.asarray(d["xy"], dtype), npts, K0, R0, t0,
            f0=float(d["f0"]),
        )
        out["triangulate_init"] = True
    else:
        X0 = jnp.asarray(d["X"], dtype)
    if args.shard_points > 0:
        from .parallel.mesh import make_mesh
        from .parallel.sharded_ba_sparse import sharded_bundle_adjust_sparse

        mesh = make_mesh({"points": args.shard_points})
        res = sharded_bundle_adjust_sparse(
            mesh, d["point_idx"], d["cam_idx"], np.asarray(d["xy"], dtype),
            X0, K0, R0, t0, f0=float(d["f0"]), axis="x-up_z-forward",
            config=cfg, cg_max_iter=args.cg_max_iter, distortion=dist,
            factor_dtype="bfloat16" if args.bf16_factors else None,
            factor_mode=("recompute" if args.recompute_factors
                         else "stored"),
        )
        out["shard_points"] = args.shard_points
        if args.bf16_factors:
            out["factor_dtype"] = "bfloat16"
    else:
        from .models.bundle_adjustment_sparse import (
            SparseObs, bundle_adjust_sparse,
        )

        obs = SparseObs(
            point_idx=jnp.asarray(d["point_idx"], jnp.int32),
            cam_idx=jnp.asarray(d["cam_idx"], jnp.int32),
            # lane-major (2, N): transpose on host so the padded (N, 2)
            # layout never reaches the device
            xy=jnp.asarray(np.ascontiguousarray(np.asarray(d["xy"]).T), dtype),
            weights=jnp.ones(d["point_idx"].shape, dtype),
        )
        res = bundle_adjust_sparse(
            obs, X0, K0, R0, t0, f0=float(d["f0"]), axis="x-up_z-forward",
            config=cfg, cg_max_iter=args.cg_max_iter, distortion=dist,
            factor_dtype="bfloat16" if args.bf16_factors else None,
            factor_mode=("recompute" if args.recompute_factors
                         else "stored"),
        )
        if args.bf16_factors:
            out["factor_dtype"] = "bfloat16"
        if args.recompute_factors:
            out["factor_mode"] = "recompute"
    out.update(
        format="bal", sparse=True,
        cams=nf, points=npts,
        observations=int(d["point_idx"].shape[0]),
        ba_iterations=int(res.n_iter),
        cg_iterations=int(res.log["cg_iters_total"]),
        reprojection_error=float(res.error),
    )
    if res.distortion is not None:
        dmat = np.asarray(res.distortion)
        out["k1_mean"] = float(dmat[:, 0].mean())
        out["k2_mean"] = float(dmat[:, 1].mean())
    if args.output_ply:
        save_ply(args.output_ply, np.asarray(res.X),
                 cameras=np.asarray(res.t))
        out["output_ply"] = args.output_ply
    if args.output_bal:
        dist_out = (
            np.asarray(res.distortion) if res.distortion is not None
            else (None if args.ignore_distortion else d["distortion"])
        )
        save_bal_sparse(
            args.output_bal, d["point_idx"], d["cam_idx"],
            np.asarray(d["xy"]), npts,
            np.asarray(res.X), np.asarray(res.R), np.asarray(res.t),
            np.asarray(res.K)[:, 0, 0], distortion=dist_out,
        )
        out["output_bal"] = args.output_bal


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    import os

    import jax

    from .runtime.cache import enable_compilation_cache

    platform = args.platform or os.environ.get("MVRECON_PLATFORM")
    if platform and platform != "default":
        # Must land before first backend use; works even when jax was
        # imported before this function ran.
        jax.config.update("jax_platforms", platform)
    if args.num_cpu_devices:
        jax.config.update("jax_num_cpu_devices", args.num_cpu_devices)

    enable_compilation_cache()
    if args.float64:
        jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp

    from .config import LMConfig
    from .geometry.scenes import make_synthetic_scene

    dtype = jnp.float64 if args.float64 else jnp.float32
    config = LMConfig(
        scale_factor=args.scale_factor,
        delta_tol=args.delta_tol,
        max_iter=args.max_iter,
    )

    out: dict = {"command": args.command}
    t_start = time.perf_counter()

    stack = contextlib.ExitStack()
    if args.profile:
        from .runtime.profiling import capture_trace

        stack.enter_context(capture_trace(args.profile))
        out["profile_dir"] = args.profile

    if args.command in ("euclidean", "affine"):
        scene = make_synthetic_scene(
            jax.random.key(args.seed), n_images=args.n_images, f=args.f,
            f0=args.f0, noise=args.noise, dtype=dtype,
        )
        if args.command == "euclidean":
            if getattr(args, "shard_points", 0) > 0:
                from .parallel.mesh import make_mesh
                from .parallel.pipelines import sharded_euclidean_reconstruction

                if args.eig_method != "eigh":
                    import sys

                    print(
                        "warning: --eig-method is ignored with --shard-points "
                        "(the sharded calibration always uses the exact "
                        "Gram-subspace eigensolve)",
                        file=sys.stderr,
                    )
                mesh = make_mesh({"points": args.shard_points})
                res = sharded_euclidean_reconstruction(
                    mesh, scene.x, f0=args.f0, tol=args.tol,
                    method=args.method, config=config,
                )
                out["shard_points"] = args.shard_points
            else:
                from .models.pipelines import euclidean_reconstruction

                res = euclidean_reconstruction(
                    scene.x, f0=args.f0, tol=args.tol, method=args.method,
                    config=config, eig_method=args.eig_method,
                )
        else:
            f_arr = jnp.full((args.n_images,), args.f, dtype=dtype)
            if getattr(args, "shard_points", 0) > 0:
                from .parallel.mesh import make_mesh
                from .parallel.pipelines import sharded_affine_reconstruction

                mesh = make_mesh({"points": args.shard_points})
                res = sharded_affine_reconstruction(
                    mesh, scene.x, f_arr, model=args.model, f0=args.f0,
                    config=config,
                )
                out["shard_points"] = args.shard_points
            else:
                from .models.pipelines import affine_reconstruction

                res = affine_reconstruction(scene.x, f_arr, model=args.model,
                                            f0=args.f0, config=config)
        out.update(
            status=int(res.status),
            ba_iterations=int(res.n_iter),
            reprojection_error=float(res.error),
            n_points=int(res.X.shape[0]),
        )
        if args.viz:
            from .geometry.camera import project_points
            from .viz import show_2d_projection_data, show_3d_scene_data

            show_3d_scene_data(res.X, res.R, res.t)
            reproj = project_points(res.X, res.K, res.R, res.t)
            show_2d_projection_data(
                [scene.x[i] for i in range(scene.x.shape[0])],
                [reproj[i] for i in range(reproj.shape[0])],
            )

    elif args.command == "reconstruct":
        from .runtime.io import load_observations, save_observations

        data = load_observations(args.input)
        x = jnp.asarray(data["x"], dtype=dtype)
        nf = x.shape[0]
        visibility = None
        if "visibility" in data:
            visibility = jnp.asarray(data["visibility"], dtype=dtype)
            out["n_visible"] = int(np.asarray(data["visibility"]).sum())
        if args.pipeline == "euclidean":
            if getattr(args, "shard_points", 0) > 0:
                from .parallel.mesh import make_mesh
                from .parallel.pipelines import sharded_euclidean_reconstruction

                mesh = make_mesh({"points": args.shard_points})
                res = sharded_euclidean_reconstruction(
                    mesh, x, f0=float(data.get("f0", args.f0)), tol=args.tol,
                    method=args.method, config=config, visibility=visibility,
                )
                out["shard_points"] = args.shard_points
            else:
                from .models.pipelines import euclidean_reconstruction

                res = euclidean_reconstruction(
                    x, f0=float(data.get("f0", args.f0)), tol=args.tol,
                    method=args.method, config=config, visibility=visibility,
                )
        else:
            from .models.pipelines import affine_reconstruction

            f_arr = jnp.asarray(
                data.get("f", np.full((nf,), args.f)), dtype=dtype
            )
            res = affine_reconstruction(x, f_arr, model=args.model,
                                        f0=args.f0, config=config,
                                        visibility=visibility)
        out.update(
            status=int(res.status),
            ba_iterations=int(res.n_iter),
            reprojection_error=float(res.error),
            n_points=int(res.X.shape[0]),
            n_views=int(nf),
        )
        if "X_gt" in data:
            # evaluation against provided ground truth: reconstruction is
            # defined up to a similarity, so align (Umeyama) before RMSE
            from .ops.procrustes import aligned_rmse

            out["aligned_rmse_gt"] = float(
                aligned_rmse(res.X, jnp.asarray(data["X_gt"], dtype=dtype))
            )
        rec_cov = None
        if getattr(args, "covariance", False):
            from .models.covariance import ba_covariance

            rec_cov = ba_covariance(
                jnp.asarray(np.asarray(x).transpose(1, 0, 2), dtype),
                res.X, res.K, res.R, res.t,
                f0=float(data.get("f0", args.f0)),
                visibility=visibility, axis="x-up_z-forward",
            )
            pt_sig = np.sqrt(np.asarray(rec_cov.point_cov).trace(
                axis1=1, axis2=2) / 3.0)
            out.update(
                sigma=float(np.sqrt(float(rec_cov.sigma2))),
                point_sigma_median=float(np.median(pt_sig)),
                point_sigma_max=float(pt_sig.max()),
            )
        if args.output:
            extra = {}
            if rec_cov is not None:
                extra["point_cov"] = np.asarray(rec_cov.point_cov)
                extra["camera_cov"] = np.asarray(rec_cov.camera_cov)
                extra["sigma2"] = np.asarray(rec_cov.sigma2)
            save_observations(
                args.output, data["x"],
                X=np.asarray(res.X), K=np.asarray(res.K),
                R=np.asarray(res.R), t=np.asarray(res.t), **extra,
            )
            out["output"] = args.output
        if args.output_ply:
            from .runtime.io import save_ply

            save_ply(
                args.output_ply, np.asarray(res.X),
                cameras=np.asarray(res.t),
                quality=(
                    None if rec_cov is None
                    else np.sqrt(np.asarray(rec_cov.point_cov).trace(
                        axis1=1, axis2=2) / 3.0)
                ),
            )
            out["output_ply"] = args.output_ply

    elif args.command == "batch":
        from .parallel.batched import batched_euclidean_reconstruction

        keys = jax.random.split(jax.random.key(args.seed), args.scenes)
        scenes = [
            make_synthetic_scene(k, n_images=args.n_images, f=args.f, f0=args.f0,
                                 noise=args.noise, dtype=dtype)
            for k in keys
        ]
        x = jnp.stack([s.x for s in scenes])
        res = batched_euclidean_reconstruction(
            x, f0=args.f0, tol=args.tol, method=args.method, config=config,
            eig_method=args.eig_method, scene_chunk=args.scene_chunk,
        )
        errs = np.asarray(res.error)
        out.update(
            scenes=args.scenes,
            statuses=[int(s) for s in np.asarray(res.status)],
            reprojection_errors=[float(e) for e in errs],
        )

    elif args.command == "bal":
        import functools
        import os

        from .runtime.io import load_bal, load_colmap

        if args.sparse:
            _cmd_bal_sparse(args, out, dtype)
            print(json.dumps(out))
            return

        if args.shard_points > 0:
            from .parallel.mesh import make_mesh
            from .parallel.sharded_ba import (
                sharded_bundle_adjust,
                sharded_bundle_adjust_chunked,
            )

            mesh = make_mesh({"points": args.shard_points})
            if args.chunk_size > 0:
                bundle_adjust = functools.partial(
                    sharded_bundle_adjust_chunked, mesh,
                    chunk_size=args.chunk_size,
                )
            else:
                bundle_adjust = functools.partial(sharded_bundle_adjust, mesh)
            out["shard_points"] = args.shard_points
        elif args.chunk_size > 0:
            from .models.bundle_adjustment_chunked import bundle_adjust_chunked

            bundle_adjust = functools.partial(
                bundle_adjust_chunked, chunk_size=args.chunk_size
            )
        else:
            from .models.bundle_adjustment import bundle_adjust

        if os.path.isdir(args.input):
            d = load_colmap(args.input)
            out["format"] = "colmap"
        else:
            d = load_bal(args.input)
        x = jnp.asarray(d["x"].transpose(1, 0, 2), dtype)  # (P, F, 2)
        vis = jnp.asarray(d["visibility"], dtype)
        in_model = str(d.get("distortion_model", "auto"))
        if in_model in ("fisheye", "fov", "thin_prism"):
            out["camera_model"] = in_model
            if args.tangential:
                raise SystemExit(
                    "--tangential fits the OPENCV (p1, p2) model; the input "
                    f"is a {in_model} camera (a different projection family)"
                )
        elif args.tangential and in_model == "radial":
            # --tangential widens a radial input to the 4-column OPENCV
            # model below; the config must agree or the resolver rejects
            # the widened array
            in_model = "opencv"
        cfg = LMConfig(
            scale_factor=args.scale_factor,
            delta_tol=args.delta_tol,
            max_iter=args.max_iter,
            damping=args.damping,
            robust=args.robust_loss if args.huber is not None else None,
            huber_delta=args.huber if args.huber is not None else 0.05,
            distortion_rounds=args.optimize_distortion,
            distortion_shared=args.shared_k,
            distortion_model=in_model,
        )
        dist = (
            None if args.ignore_distortion
            else jnp.asarray(d["distortion"], dtype)
        )
        if args.tangential and not args.ignore_distortion:
            if dist is None or dist.shape[-1] == 2:
                base = (
                    jnp.zeros((int(vis.shape[1]), 2), dtype)
                    if dist is None else dist
                )
                dist = jnp.concatenate([base, jnp.zeros_like(base)], axis=-1)
        res = bundle_adjust(
            x, jnp.asarray(d["X"], dtype), jnp.asarray(d["K"], dtype),
            jnp.asarray(d["R"], dtype), jnp.asarray(d["t"], dtype),
            f0=float(d["f0"]), axis="x-up_z-forward", config=cfg,
            visibility=vis, distortion=dist,
        )
        out.update(
            cams=int(vis.shape[1]),
            points=int(vis.shape[0]),
            observations=int(np.asarray(vis).sum()),
            ba_iterations=int(res.n_iter),
            reprojection_error=float(res.error),
        )
        cov = None
        if args.covariance:
            from .models.covariance import ba_covariance, ba_covariance_chunked

            cov_fn = (
                functools.partial(ba_covariance_chunked,
                                  chunk_size=args.chunk_size)
                if args.chunk_size > 0 else ba_covariance
            )
            cov = cov_fn(
                x, res.X, res.K, res.R, res.t, f0=float(d["f0"]),
                visibility=vis, axis="x-up_z-forward", config=cfg,
                distortion=res.distortion,
            )
            pt_sig = np.sqrt(np.asarray(cov.point_cov).trace(
                axis1=1, axis2=2) / 3.0)
            cam_t_sig = np.sqrt(np.asarray(
                cov.camera_cov)[:, 3:6, 3:6].trace(axis1=1, axis2=2) / 3.0)
            out.update(
                sigma=float(np.sqrt(float(cov.sigma2))),
                point_sigma_median=float(np.median(pt_sig)),
                point_sigma_max=float(pt_sig.max()),
                camera_pos_sigma_median=float(np.median(cam_t_sig)),
            )
        if res.distortion is not None:
            dmat = np.asarray(res.distortion)
            if dmat.shape[-1] == 1:  # FOV model: one angle
                out["omega_mean"] = float(dmat[:, 0].mean())
                dmat = None
        if res.distortion is not None and dmat is not None:
            out["k1_mean"] = float(dmat[:, 0].mean())
            out["k2_mean"] = float(dmat[:, 1].mean())
            if dmat.shape[-1] == 8:
                names = (
                    ("k3", "k4", "p1", "p2", "sx1", "sy1")
                    if in_model == "thin_prism"
                    else ("k3", "k4", "k5", "k6", "p1", "p2")
                )
                for j, name in enumerate(names, start=2):
                    out[f"{name}_mean"] = float(dmat[:, j].mean())
            elif dmat.shape[-1] == 4:
                n3, n4 = ("k3", "k4") if in_model == "fisheye" else ("p1", "p2")
                out[f"{n3}_mean"] = float(dmat[:, 2].mean())
                out[f"{n4}_mean"] = float(dmat[:, 3].mean())
        if args.output:
            from .runtime.io import save_observations

            extra = {}
            if res.distortion is not None:
                extra["distortion"] = np.asarray(res.distortion)
            if cov is not None:
                extra["point_cov"] = np.asarray(cov.point_cov)
                extra["camera_cov"] = np.asarray(cov.camera_cov)
                extra["sigma2"] = np.asarray(cov.sigma2)
            save_observations(
                args.output, d["x"],
                X=np.asarray(res.X), K=np.asarray(res.K),
                R=np.asarray(res.R), t=np.asarray(res.t),
                visibility=d["visibility"], **extra,
            )
            out["output"] = args.output
        dist_out = (
            np.asarray(res.distortion) if res.distortion is not None
            else (None if args.ignore_distortion else d["distortion"])
        )
        if args.output_colmap:
            from .runtime.io import save_colmap

            save_colmap(
                args.output_colmap, d["x"], d["visibility"],
                np.asarray(res.X), np.asarray(res.R), np.asarray(res.t),
                np.asarray(res.K)[:, 0, 0],
                principal_point=np.asarray(res.K)[:, :2, 2],
                distortion=dist_out,
                distortion_model=(in_model if in_model in
                                  ("fisheye", "thin_prism") else None),
            )
            out["output_colmap"] = args.output_colmap
        if args.output_bal:
            from .runtime.io import save_bal

            if dist_out is not None and np.asarray(dist_out).shape[-1] != 2:
                raise SystemExit(
                    "--output-bal: BAL carries only (k1, k2); this model is "
                    "4-parameter — use --output-colmap"
                )
            save_bal(
                args.output_bal, d["x"], d["visibility"],
                np.asarray(res.X), np.asarray(res.R), np.asarray(res.t),
                np.asarray(res.K)[:, 0, 0],
                distortion=dist_out,
            )
            out["output_bal"] = args.output_bal
        if args.output_colmap_pinhole:
            from .models.bundle_adjustment import undistort_points
            from .runtime.io import save_colmap

            if dist_out is None:
                x_un = x
            else:
                x_un = undistort_points(
                    x, res.K[:, 0, 0], res.K[:, :2, 2],
                    f0=float(d["f0"]), distortion=jnp.asarray(dist_out, dtype),
                    distortion_model=in_model,
                )
            save_colmap(
                args.output_colmap_pinhole,
                np.asarray(x_un).transpose(1, 0, 2), d["visibility"],
                np.asarray(res.X), np.asarray(res.R), np.asarray(res.t),
                np.asarray(res.K)[:, 0, 0],
                principal_point=np.asarray(res.K)[:, :2, 2],
            )
            out["output_colmap_pinhole"] = args.output_colmap_pinhole
        if args.output_ply:
            from .runtime.io import save_ply

            save_ply(
                args.output_ply, np.asarray(res.X),
                cameras=np.asarray(res.t),
                quality=(
                    None if cov is None
                    else np.sqrt(np.asarray(cov.point_cov).trace(
                        axis1=1, axis2=2) / 3.0)
                ),
            )
            out["output_ply"] = args.output_ply

    elif args.command == "bench-ba":
        scene = make_synthetic_scene(
            jax.random.key(0), n_images=args.views, n_slices=args.points // 20,
            n_angles=20, noise=args.noise, dtype=dtype,
        )
        k1, k2 = jax.random.split(jax.random.key(0))
        X0 = scene.X + 0.05 * jax.random.normal(k1, scene.X.shape, dtype=dtype)
        t0 = scene.t + 0.05 * jax.random.normal(k2, scene.t.shape, dtype=dtype)
        x = scene.x.transpose(1, 0, 2)
        cfg = LMConfig(scale_factor=args.scale_factor, delta_tol=0.0,
                       max_iter=args.iters)

        if args.chunked:
            from .models.bundle_adjustment_chunked import bundle_adjust_chunked as ba_fn

            def run():
                r = ba_fn(x, X0, scene.K, scene.R, t0, f0=args.f0,
                          axis="x-up_z-forward", config=cfg,
                          chunk_size=args.chunk_size)
                return r, float(r.error)
        else:
            from .models.bundle_adjustment import bundle_adjust as ba_fn

            def run():
                r = ba_fn(x, X0, scene.K, scene.R, t0, f0=args.f0,
                          axis="x-up_z-forward", config=cfg)
                return r, float(r.error)

        _, err = run()  # compile
        t1 = time.perf_counter()
        _, err = run()
        out.update(
            points=args.points, views=args.views, iters=args.iters,
            wall_s=round(time.perf_counter() - t1, 4),
            reprojection_error=err,
        )

    stack.close()
    out["total_wall_s"] = round(time.perf_counter() - t_start, 2)
    line = json.dumps(out)
    if args.log_json:
        with open(args.log_json, "a") as fh:
            fh.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
