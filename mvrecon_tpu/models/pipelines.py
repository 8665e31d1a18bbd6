"""End-to-end reconstruction pipelines.

Capability parity: the reference's two demo drivers
(``affine_reconstruction.py:14-65``, ``euclidiean_reconstruction.py:13-66``)
re-expressed as jittable functions over a scene's observations — no global
RNG, no prints, no plotting inside; visualization/logging happen at the
edges. These are the "flagship models" of the framework: each maps
observations (F, P, 2) -> reconstruction (X, K, R, t) + diagnostics, and
both vmap over a leading scenes axis (see ``parallel/batched.py``).

Each pipeline runs its stages through their own jitted entry points rather
than one monolithic jit: the stage programs are already compiled+cached
individually, compile times stay bounded (monolithic calib+BA programs
take minutes to build), and the host transfer
between stages is a few KB. The batched variants in ``parallel/batched.py``
re-fuse everything under one jit+vmap where it pays off.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import LMConfig
from ..runtime.profiling import trace_span
from .affine import affine_self_calibration
from .bundle_adjustment import BAResult, bundle_adjust
from .perspective import perspective_self_calibration


class ReconstructionResult(NamedTuple):
    X: jax.Array  # (P, 3)
    K: jax.Array  # (F, 3, 3)
    R: jax.Array  # (F, 3, 3)
    t: jax.Array  # (F, 3)
    error: jax.Array  # final BA reprojection error (sum of squares / f0^2)
    n_iter: jax.Array  # BA iterations
    calib_X: jax.Array  # pre-BA points (the self-calibration output)
    status: jax.Array  # perspective calibration status (0 = ok); 0 for affine
    # stacked device-side BA iteration log when config.record_log is set
    # (feed through runtime.logging.device_log_to_records to viz.animate —
    # the reference's get_log/animate replay, bundle_adjustment.py:204-206)
    ba_log: dict | None = None


def affine_reconstruction(
    x: jax.Array,
    f: jax.Array,
    model: str = "paraperspective",
    f0: float = 1.0,
    config: LMConfig = LMConfig(scale_factor=2.0, delta_tol=1e-8, max_iter=100),
    visibility: jax.Array | None = None,
) -> ReconstructionResult:
    """Affine pipeline (reference ``affine_reconstruction.py:43-58``):
    self-calibration -> heuristic camera init (t = -3 R[:, :, 2], K = I)
    -> bundle adjustment in the x-up_z-forward gauge.

    x: (F, P, 2) observations; f: (F,) focal lengths (paraperspective);
    visibility: optional (P, F) mask, honored by BA only — the calibration
    stage keeps the reference's full-visibility contract
    (``affine_camera_calibration.py:232-234``), so masked entries of ``x``
    must still hold finite placeholder coordinates.
    """
    with trace_span("affine_self_calibration"):
        S, R = affine_self_calibration(x, model=model, f=f)
    t = -3.0 * R[:, :, 2]
    K = jnp.broadcast_to(jnp.eye(3, dtype=x.dtype), R.shape)

    with trace_span("bundle_adjustment"):
        ba = bundle_adjust(
            x.transpose(1, 0, 2),
            S,
            K,
            R,
            t,
            f0=f0,
            visibility=visibility,
            axis="x-up_z-forward",
            config=config,
        )
    return ReconstructionResult(
        X=ba.X,
        K=ba.K,
        R=ba.R,
        t=ba.t,
        error=ba.error,
        n_iter=ba.n_iter,
        calib_X=S,
        status=jnp.asarray(0),
        ba_log=ba.log,
    )


def euclidean_reconstruction(
    x: jax.Array,
    f0: float = 1.0,
    tol: float = 1e-2,
    method: str = "dual",
    config: LMConfig = LMConfig(scale_factor=2.0, delta_tol=1e-8, max_iter=100),
    eig_method: str = "eigh",
    visibility: jax.Array | None = None,
) -> ReconstructionResult:
    """Perspective pipeline (reference ``euclidiean_reconstruction.py:
    42-56``): perspective self-calibration (projective depths + metric
    upgrade) -> bundle adjustment in the x-up_z-forward gauge.

    visibility: optional (P, F) mask, honored by BA only — calibration
    keeps the reference's full-visibility contract (masked ``x`` entries
    need finite placeholders)."""
    with trace_span("perspective_self_calibration"):
        calib = perspective_self_calibration(
            x, f0=f0, tol=tol, method=method, eig_method=eig_method
        )

    with trace_span("bundle_adjustment"):
        ba = bundle_adjust(
            x.transpose(1, 0, 2),
            calib.X,
            calib.K,
            calib.R,
            calib.t,
            f0=f0,
            visibility=visibility,
            axis="x-up_z-forward",
            config=config,
        )
    return ReconstructionResult(
        X=ba.X,
        K=ba.K,
        R=ba.R,
        t=ba.t,
        error=ba.error,
        n_iter=ba.n_iter,
        calib_X=calib.X,
        status=calib.status,
        ba_log=ba.log,
    )


def euclidean_reconstruction_large(
    x: jax.Array,
    f0: float = 1.0,
    tol: float = 1e-2,
    method: str = "dual",
    config: LMConfig = LMConfig(
        scale_factor=4.0, delta_tol=0.0, max_iter=6,
        accept_divisor=1.0, init_damping=3e-3, damping="nielsen",
    ),
    chunk_size: int = 768,
    bootstrap_frac: float = 0.1,
    bootstrap_iters: int = 0,
    mesh=None,
) -> ReconstructionResult:
    """Large-scale perspective pipeline: self-calibration -> [optional
    hierarchical camera bootstrap] -> full-scale chunked BA.

    The reference pipeline (``euclidiean_reconstruction.py:42-56``) feeds
    calibration's output straight into BA. With the projective-scale K
    normalization (``bundle_adjustment.intrinsics_from_K`` — the round-5
    root-cause fix: self-calibration returns K up to per-camera scale and
    the raw ``K[0, 0]`` read misinitialized the focal ~10x) the
    calibration init enters BA at ~1.04x the noise floor, so the default
    here is simply a SHORT full-scale budget (a few polish iterations).

    ``bootstrap_iters > 0`` additionally converges the cameras first on a
    strided ``bootstrap_frac`` point subsample (a BA whose Schur build
    costs ~``bootstrap_frac`` of full scale) and DLT re-triangulates all
    points from the converged cameras — the recovery path for genuinely
    weak inits (measured in scripts/exp_pipeline_init.py: from a
    ~500x-floor init it cuts full-scale iterations-to-floor 16 -> 4).
    Caution: an UNDER-converged bootstrap makes DLT re-triangulation
    catastrophically worse than no bootstrap (measured: cameras at 1.5x
    their subsample floor yield DLT points at ~1e8x floor — a few
    near-degenerate triangulations dominate), so give the bootstrap
    enough iterations to actually converge.

    With ``mesh`` the calibration runs sharded
    (``parallel/sharded_calibration.py`` — required at 100k x 1000, where
    the one-shot depth factor alone is 4.47 GB); otherwise the plain
    single-device calibration is used.
    """
    from ..ops.triangulation import triangulate
    from .bundle_adjustment_chunked import bundle_adjust_chunked

    with trace_span("perspective_self_calibration"):
        if mesh is not None:
            from ..parallel.sharded_calibration import (
                sharded_perspective_self_calibration,
            )

            calib = sharded_perspective_self_calibration(
                mesh, x, f0=f0, tol=tol, method=method
            )
        else:
            calib = perspective_self_calibration(
                x, f0=f0, tol=tol, method=method, eig_method="lowrank"
            )

    n_points = x.shape[1]
    x_pf = x.transpose(1, 0, 2)  # (P, F, 2)

    if bootstrap_iters > 0:
        with trace_span("camera_bootstrap_ba"):
            sub = max(int(n_points * bootstrap_frac), min(n_points, 200))
            stride = max(n_points // sub, 1)
            idx = jnp.arange(0, stride * sub, stride)
            boot_cfg = LMConfig(
                scale_factor=4.0, delta_tol=0.0, max_iter=bootstrap_iters,
                accept_divisor=1.0, init_damping=3e-3, damping="nielsen",
            )
            boot = bundle_adjust_chunked(
                x_pf[idx], calib.X[idx], calib.K, calib.R, calib.t,
                f0=f0, axis="x-up_z-forward", config=boot_cfg,
                chunk_size=min(chunk_size, sub),
            )
        with trace_span("retriangulate"):
            X_init = triangulate(x, boot.K, boot.R, boot.t, f0=f0)
        K_init, R_init, t_init = boot.K, boot.R, boot.t
    else:
        X_init, K_init, R_init, t_init = calib.X, calib.K, calib.R, calib.t

    with trace_span("bundle_adjustment"):
        ba = bundle_adjust_chunked(
            x_pf, X_init, K_init, R_init, t_init,
            f0=f0, axis="x-up_z-forward", config=config,
            chunk_size=chunk_size,
        )
    return ReconstructionResult(
        X=ba.X,
        K=ba.K,
        R=ba.R,
        t=ba.t,
        error=ba.error,
        n_iter=ba.n_iter,
        calib_X=calib.X,
        status=calib.status,
        ba_log=ba.log,
    )
