"""Global numerics / execution configuration.

The reference implementation is float64 NumPy end-to-end. GPUs compute
fastest in f32 and below; float64 is available only when x64 is enabled
(and runs at a small fraction of the f32 rate on the GPU). The framework
is dtype-polymorphic: every public entry point derives its working dtype
from its inputs, so

- parity mode: feed float64 arrays (with ``JAX_ENABLE_X64=1``) and get the
  reference's float64 semantics (used by the test suite on CPU);
- fast mode: feed float32 arrays (the GPU path).

``default_dtype()`` is what synthetic-data helpers use when the caller does
not specify one.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import jax
import jax.numpy as jnp

# Matmul/einsum precision for numerically sensitive contractions. On the
# GPU an f32 contraction at DEFAULT precision runs in TF32 on the tensor
# cores (~3 significant digits per operand); HIGHEST forces full FP32,
# which the small-but-ill-conditioned normal equations here need.
#
# Set MVRECON_PRECISION=default (before import) to let the heavy matmuls
# run in TF32 — LM's accept/retry protocol tolerates an approximate
# Gauss-Newton system, at the price of more retries. Parity tests always
# run f64 on CPU where this constant is a no-op.
_PRECISION_MODES = {
    "highest": jax.lax.Precision.HIGHEST,
    "default": jax.lax.Precision.DEFAULT,
}
HIGHEST = _PRECISION_MODES[os.environ.get("MVRECON_PRECISION", "highest").lower()]

# Full-precision constant for O(F)/O(P)-sized state transforms (gauge
# normalization, rotation composition): these are too small to matter for
# throughput but a reduced-precision pass there corrupts LM trial states
# (rejected-step storms), so they stay at HIGHEST even under
# MVRECON_PRECISION=default.
STATE_HIGHEST = jax.lax.Precision.HIGHEST


def default_dtype() -> jnp.dtype:
    """float64 when x64 is enabled (parity/CPU), else float32."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def result_dtype(*arrays: Any) -> jnp.dtype:
    dt = jnp.result_type(*[a for a in arrays if a is not None])
    if not jnp.issubdtype(dt, jnp.floating):
        return default_dtype()
    return dt


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Levenberg–Marquardt hyperparameters.

    Defaults mirror the reference driver calls
    (``optimize(2.0, 1e-8, max_iter=100)``, init damping ``c=1e-4``).
    """

    scale_factor: float = 10.0
    delta_tol: float = 1e-8
    max_iter: int = 100
    init_damping: float = 1e-4
    max_inner_retries: int = 64  # bound for the (unbounded) reference retry loop
    record_log: bool = False  # keep per-iteration (X, R, t, E) for animation
    # damping divisor applied after an accepted step; None = scale_factor
    # (the reference protocol, bundle_adjustment.py:195). Every failed retry
    # at large scale costs a full Schur rebuild, so large-scene configs can
    # set accept_divisor=1.0 (never shrink damping) to trade slightly
    # smaller steps for ~1 retry per iteration.
    accept_divisor: float | None = None
    # damping adaptation: "reference" = multiply/divide by scale_factor
    # (the reference protocol); "nielsen" = gain-ratio adaptation
    # (c *= max(1/3, 1-(2 rho-1)^3) on accept, c *= nu, nu *= 2 on reject)
    # - fewer wasted retries when each retry is a full Schur rebuild.
    damping: str = "reference"
    # robust loss: None = plain least squares (reference); otherwise an
    # IRLS loss recomputed each outer iteration ("huber", "cauchy",
    # "soft_l1", "arctan" — the ceres LossFunction family; see
    # models/bundle_adjustment.robust_weight) - gross outliers stop
    # dominating the normal equations. huber_delta is the scale
    # parameter for every kind (residual-magnitude units).
    robust: str | None = None
    huber_delta: float = 0.05
    # radial-distortion optimization (BAL camera model): number of
    # (geometry LM -> closed-form per-camera k1/k2 refit) alternations to
    # run before the final LM pass. 0 = distortion (if provided to
    # bundle_adjust) is held fixed. Each k-refit is exact: the BAL
    # prediction is linear in (k1, k2) given the geometry.
    distortion_rounds: int = 0
    # tie (k1, k2) across all cameras during the refit (one physical
    # camera captured the sequence) — well-posed even when single frames
    # see too few rays to identify their own distortion.
    distortion_shared: bool = False
    # how to interpret the ``distortion`` columns: "auto" maps (F, 2) to
    # the BAL radial model and (F, 4) to OPENCV (k1, k2, p1, p2);
    # "fisheye" reads (F, 4) as OPENCV_FISHEYE (k1..k4 polynomial in
    # theta on the equidistant projection). "radial"/"opencv" pin the
    # auto choices explicitly.
    distortion_model: str = "auto"
    # symmetric Jacobi (diagonal) scaling of the reduced camera system
    # before its Cholesky solve: A' = D A D, D = diag(A)^-1/2. Exact in
    # real arithmetic; in f32 it equalizes the f/u/t/omega column scales
    # (which differ by orders of magnitude), reducing rounding in the
    # factorization - a candidate lever on the LM retry count at the
    # 100k x 1000 north star. Chunked core only.
    jacobi_scaling: bool = False

    @property
    def divisor(self) -> float:
        return self.scale_factor if self.accept_divisor is None else self.accept_divisor


@dataclasses.dataclass(frozen=True)
class DepthConfig:
    """Projective-depth iteration hyperparameters (reference defaults:
    tol driver-set, max_iter 200 primary / 50 dual)."""

    tolerance: float = 0.01
    max_iter: int = 200


@dataclasses.dataclass(frozen=True)
class UpgradeConfig:
    """Euclidean upgrading loop (reference loop is unbounded; stops on
    median self-calibration cost ``J`` < 1e-8 or non-decreasing)."""

    j_tol: float = 1e-8
    max_iter: int = 100
