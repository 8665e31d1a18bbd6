"""Levenberg–Marquardt bundle adjustment with camera/point Schur elimination.

Capability parity: reference ``lib/bundle_adjustment.py`` (class
``BundleAdjuster``) — minimizes the sum of squared reprojection errors over
all 3D points X (3P params) and per-camera (f, u0, v0, t, omega) (9F
params), with gauge fixing (camera-0 pose + one baseline component = 7 DoF,
``:62-72``), analytic first/second derivatives (``:309-427``), and the
point-block Schur complement (``:118-152``).

Accelerator-first re-design (not a port):

- **Pure function over a PyTree state.** The reference's mutable class
  becomes ``lm_optimize(observations, init_state, config) -> result``; the
  outer LM iteration and the inner damping retry are bounded
  ``lax.while_loop``s. The inner retry reuses the precomputed derivative
  tensors exactly as the reference does (``:118-167`` re-damps and
  re-solves without recomputing derivatives).

- **Static shapes via gauge masks.** The reference deletes 7 rows/columns
  (dynamic shapes, ``np.insert``/boolean indexing at ``:62-72, :267,
  :511-515, :610-614, :658-662``). Here the full 9F system is kept and the
  7 gauge-fixed parameters are projected out with a mask (their rows/cols
  are identity in the reduced camera matrix, their gradient entries zero),
  which yields the identical solution with XLA-friendly static shapes.

- **Matmul-shaped Schur.** Per-point 3x3 blocks are inverted in closed form
  (adjugate, elementwise); the reduced camera system
  ``A = blockdiag(G) - sum_p F_p^T E_p^-1 F_p`` is accumulated as one
  (9F, 3P) x (3P, 9F) matmul — one large GEMM does the heavy lifting. A chunked
  ``lax.scan`` variant (``models/bundle_adjustment_chunked.py``) streams
  points through HBM for the 100k-point regime.

- **Derivatives are broadcast, never tiled** (the reference materializes
  (P, F, 3) tiles of per-camera constants, ``:318-320, :368-377``).

All math (projection pqr, d_P/d_F, matE/matF/matG, damping protocol,
stopping rules, coordinate gauge normalize/restore) matches the reference
line-for-line in *semantics*; citations on each function.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import HIGHEST, STATE_HIGHEST, LMConfig
from ..ops.linalg import inv3x3, inv9_spd
from ..ops.rotations import rodrigues


class BAState(NamedTuple):
    """Optimizable parameters (normalized gauge frame)."""

    X: jax.Array  # (P, 3)
    f: jax.Array  # (F,)
    u: jax.Array  # (F, 2)
    t: jax.Array  # (F, 3)
    R: jax.Array  # (F, 3, 3)


class BAResult(NamedTuple):
    X: jax.Array  # (P, 3) in the original (global) frame
    K: jax.Array  # (F, 3, 3)
    R: jax.Array  # (F, 3, 3)
    t: jax.Array  # (F, 3)
    error: jax.Array  # final reprojection error E (sum of squares)
    n_iter: jax.Array
    log: dict | None  # stacked per-iteration (X, R, t, E) when recorded
    distortion: jax.Array | None = None  # (F, n) model params when modeled
    # (n selects the family via resolve_distortion_model / the config tag)


AXIS_MODES = ("x-right_z-forward", "x-up_z-forward")


def _axis_index(axis: str) -> int:
    """0 for x-right (baseline component t1_x), 1 for x-up (t1_y)
    (reference ``:62-72, :227-238``)."""
    if axis not in AXIS_MODES:
        raise ValueError(f"unknown axis mode: {axis}")
    return AXIS_MODES.index(axis)


def gauge_mask(n_images: int, axis: str, dtype) -> jax.Array:
    """(9F,) mask: 0 at the 7 gauge-fixed camera parameters
    (camera-0 t and omega, plus one component of t1 — reference
    ``_remove_ind`` at ``bundle_adjustment.py:62-72``), 1 elsewhere."""
    ax = _axis_index(axis)
    mask = np.ones(9 * n_images, dtype=bool)
    mask[[3, 4, 5, 6, 7, 8]] = False  # camera-0 t, omega
    mask[12 + ax] = False  # t1_x (x-right) or t1_y (x-up)
    return jnp.asarray(mask, dtype=dtype)


def normalize_gauge(
    X: jax.Array, R: jax.Array, t: jax.Array, axis: str
) -> tuple[jax.Array, jax.Array, jax.Array, dict]:
    """Normalize the scene to camera 0 with a unit baseline component
    (reference ``_transform_to_normalize_coodinates``, ``:208-240``).
    Returns the normalized (X, R, t) and the restore info
    (R0, t0, c0c1_len) (``:22-33``)."""
    ax = _axis_index(axis)
    # All gauge transforms pin HIGHEST: a default-precision (TF32 on the
    # GPU) rotation of X perturbs points by ~1e-2 relative, visibly
    # bumping the reprojection error across a checkpoint/restore boundary.
    c0c1_len = jnp.abs(jnp.vdot(R[0, :, ax], t[1] - t[0], precision=STATE_HIGHEST))

    X_ = X - t[0]
    t_ = t - t[0]
    # Deliberate deviation from the reference (``:226-235``): the sign is
    # taken from the baseline's ax-component IN THE CAMERA-0 FRAME (the
    # same frame ``c0c1_len`` measures), not the world frame. With the
    # reference's world-frame sign, restore(normalize(state)) NEGATES the
    # scene about camera 0 whenever the two frames' signs disagree — an
    # E-invariant but cheirality-flipping mirror that breaks every
    # composition (segmented resume, scene-compaction phases, checkpoint
    # restart). With the camera-frame sign, s == c0c1_len exactly and
    # restore ∘ normalize is the identity unconditionally; single-call
    # results change only on inputs where the reference itself would
    # return the mirrored scene.
    comp = jnp.vdot(R[0, :, ax], t_[1], precision=STATE_HIGHEST)
    s = jnp.abs(comp)
    X_ = jnp.matmul(X_, R[0], precision=STATE_HIGHEST) / s
    R_ = jnp.einsum("ji,fjk->fik", R[0], R, precision=STATE_HIGHEST)
    t_ = jnp.matmul(t_, R[0], precision=STATE_HIGHEST) / s
    return X_, R_, t_, {"R0": R[0], "t0": t[0], "scale": c0c1_len}


def restore_gauge(
    info: dict, X: jax.Array, R: jax.Array, t: jax.Array
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Invert ``normalize_gauge`` using the saved camera-0 frame and the
    original baseline length (reference ``:242-258``)."""
    r0, t0, scale = info["R0"], info["t0"], info["scale"]
    X_ = jnp.matmul(scale * X, r0.T, precision=STATE_HIGHEST) + t0
    t_ = jnp.matmul(scale * t, r0.T, precision=STATE_HIGHEST) + t0
    R_ = jnp.einsum("ij,fjk->fik", r0, R, precision=STATE_HIGHEST)
    return X_, R_, t_


def build_K(f: jax.Array, u: jax.Array, f0: float) -> jax.Array:
    """(F, 3, 3) intrinsics from f, (u0, v0), f0 (reference ``:283-289``)."""
    nf = f.shape[0]
    k = jnp.zeros((nf, 3, 3), dtype=f.dtype)
    k = k.at[:, 0, 0].set(f)
    k = k.at[:, 1, 1].set(f)
    k = k.at[:, :2, 2].set(u)
    k = k.at[:, 2, 2].set(f0)
    return k


def intrinsics_from_K(K: jax.Array, f0: float):
    """(f, u) of the BA camera parameterization
    ``K = [[f, 0, u0], [0, f, v0], [0, 0, f0]]`` from an arbitrary
    projective-scale input K: rescale to ``K[2, 2] == f0`` first, then
    read the diagonal/principal point.

    Self-calibration returns K only up to a per-camera projective scale
    (the metric upgrade fixes C = K K^T up to scale; measured
    K[2, 2] ~ 0.08-0.11 on the synthetic scenes). The reference's BA
    reads ``init_K[:, 0, 0]`` raw (``bundle_adjustment.py:45-49``), so
    a scaled K silently misinitializes the focal by K22/f0 — measured:
    a calibration init whose true reprojection error is 1.04x the noise
    floor enters BA at 509x, and the 100k x 1000 pipeline needed a
    40-iteration budget just to re-learn f and u. Rescaling is exact
    (the camera matrix K [R^T | -R^T t] is homogeneous), so this is a
    documented strictly-better deviation, not a behavior change at
    convergence (docs/PARITY.md)."""
    s = f0 / K[:, 2, 2]
    return K[:, 0, 0] * s, K[:, :2, 2] * s[:, None]


def calc_pqr(
    X: jax.Array, K: jax.Array, R: jax.Array, t: jax.Array
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Camera matrices P (F, 3, 4) and homogeneous image coordinates
    (p, q, r) each (P, F) (reference ``_calc_pqr``, ``:291-307``)."""
    # STATE_HIGHEST (not the env-controlled HIGHEST): the K=4 contraction
    # is negligible FLOPs, and accurate (p, q, r) are what LM acceptance
    # decisions are made from — bf16 here swamps noise-floor residuals.
    rt = jnp.swapaxes(R, -1, -2)
    trans = -jnp.einsum("fij,fj->fi", rt, t, precision=STATE_HIGHEST)
    pmat = jnp.einsum(
        "fij,fjk->fik", K, jnp.concatenate([rt, trans[..., None]], axis=-1),
        precision=STATE_HIGHEST,
    )
    xh = jnp.concatenate([X, jnp.ones((X.shape[0], 1), dtype=X.dtype)], axis=-1)
    pqr = jnp.einsum("fca,pa->pfc", pmat, xh, precision=STATE_HIGHEST)  # (P, F, 3)
    return pmat, pqr[..., 0], pqr[..., 1], pqr[..., 2]


def reprojection_error(
    x: jax.Array, p: jax.Array, q: jax.Array, r: jax.Array, vis: jax.Array, f0: float
) -> jax.Array:
    """Sum of squared residuals E (reference ``:666-677``). r is sanitized
    where vis == 0 so masked/padded entries cannot produce 0 * inf."""
    r = jnp.where(vis > 0, r, jnp.ones_like(r))
    e = (p / r - x[..., 0] / f0) ** 2 + (q / r - x[..., 1] / f0) ** 2
    return jnp.sum(vis * e)


DISTORTION_MODELS = ("radial", "opencv", "fisheye", "full_opencv", "fov",
                     "thin_prism")
_DISTORTION_NCOLS = {"radial": 2, "opencv": 4, "fisheye": 4,
                     "full_opencv": 8, "fov": 1, "thin_prism": 8}


def resolve_distortion_model(
    dist: jax.Array | None, model: str | None = "auto"
) -> str:
    """Concrete distortion-model name from (columns, requested model).

    "auto" (the ``LMConfig.distortion_model`` default) keeps the
    column-count convention: (F, 2) = BAL radial, (F, 4) = OPENCV.
    OPENCV_FISHEYE also carries 4 parameters (k1..k4), so it must be
    requested explicitly."""
    if model in (None, "auto"):
        if dist is None:
            return "radial"
        n = int(dist.shape[-1])
        if n == 1:
            return "fov"
        if n == 2:
            return "radial"
        if n == 4:
            return "opencv"
        if n == 8:
            return "full_opencv"
        raise ValueError(
            f"distortion must have 1, 2, 4, or 8 columns, got {n}"
        )
    if model not in DISTORTION_MODELS:
        raise ValueError(f"unknown distortion model: {model!r}")
    if dist is not None and int(dist.shape[-1]) != _DISTORTION_NCOLS[model]:
        raise ValueError(
            f"{model} distortion expects {_DISTORTION_NCOLS[model]} columns, "
            f"got {dist.shape[-1]}"
        )
    return model


def default_distortion(model: str, nf: int, dtype) -> jax.Array:
    """Refit-from-scratch initial distortion for ``model``. Zero for
    every polynomial family; the FOV angle starts at 0.5 rad — omega = 0
    is the pinhole limit where d(d)/d(omega) vanishes (the guard in
    ``_fov_domega``), so a zero init would pin the scalar Gauss-Newton
    refit at exactly zero."""
    if model == "fov":
        return jnp.full((nf, 1), 0.5, dtype)
    return jnp.zeros((nf, _DISTORTION_NCOLS[model]), dtype)


def distortion_nterms(model: str) -> int:
    """Columns of the per-camera normal-equation accumulands of the
    closed-form refit (``_distortion_lsq_terms`` /
    ``_full_opencv_lsq_terms``)."""
    if model == "radial":
        return 5
    if model == "full_opencv":
        return 30  # 5x5 normal matrix + 5 rhs (the larger of its rounds)
    if model == "fov":
        return 2  # scalar Gauss-Newton numerator/denominator per step
    if model == "thin_prism":
        return 72  # 8x8 normal matrix + 8 rhs
    return 20


def _distortion_terms(
    state: BAState, p: jax.Array, q: jax.Array, r: jax.Array, f0: float,
    dist: jax.Array, model: str | None = None,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array, jax.Array]:
    """Per-observation distortion quantities shared by every chain-rule
    consumer. Returns (g1, g2, s, d, wu) such that for the radial-family
    part of any model the distorted prediction is ``pi~ = d g + u/f0``
    and the exact 2x2 Jacobian chain is ``D = d I + cw g g^T`` with
    ``cw = wu (f0/f)^2``; the explicit f-column correction is
    ``-(wu s / f) g`` (both identities hold for each model below with
    its own d and wu — the chain code is model-agnostic).

    radial (BAL camera model, ``runtime/io.py::load_bal``): pixel =
    f * d(s) rho on the normalized ray rho = Xc_xy / Xc_z with
    d = 1 + k1 s + k2 s^2, s = |rho|^2. In f0-normalized image
    coordinates the undistorted prediction is pi = (p/r, q/r) =
    (f/f0) rho + u/f0, so with g = pi - u/f0 it becomes d(s) g + u/f0
    and wu = 2 dd/ds = 2 (k1 + 2 k2 s).

    fisheye (COLMAP OPENCV_FISHEYE / OpenCV cv::fisheye): the
    equidistant projection theta_d(theta) = theta (1 + k1 theta^2 +
    k2 theta^4 + k3 theta^6 + k4 theta^8) with theta = atan(|rho|);
    the prediction is m g + u/f0 with the radial scale m =
    theta_d / |rho| and wu = (dm/d|rho|) / |rho| (Taylor-safe at the
    principal point, where m -> 1 and wu -> 2 (k1 - 1/3)).

    ``r`` must already be sanitized (nonzero where masked)."""
    model = resolve_distortion_model(dist, model)
    g1 = p / r - (state.u[:, 0] / f0)[None]  # (P, F)
    g2 = q / r - (state.u[:, 1] / f0)[None]
    ratio2 = (f0 / state.f) ** 2  # (F,)
    s = ratio2[None] * (g1 * g1 + g2 * g2)
    if model == "fisheye":
        d, wu = _fisheye_scale(s, dist)
        return g1, g2, s, d, wu
    if model == "full_opencv":
        d, wu = _rational_scale(s, dist)
        return g1, g2, s, d, wu
    if model == "fov":
        d, wu = _fov_scale(s, dist)
        return g1, g2, s, d, wu
    if model == "thin_prism":
        raise ValueError(
            "thin_prism is a two-stage model (equidistant base + "
            "theta-plane shift) and has no scalar (d, wu) form — use "
            "_thin_prism_terms / _apply_thin_prism_chain"
        )
    k1 = dist[:, 0][None]
    k2 = dist[:, 1][None]
    d = 1.0 + s * (k1 + s * k2)
    wu = 2.0 * (k1 + 2.0 * k2 * s)
    return g1, g2, s, d, wu


def _fov_scale(s: jax.Array, dist: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(d, d'/rn) of the FOV model (Devernay-Faugeras / COLMAP model 7)
    at rn = sqrt(s): r_d = atan(2 rn tan(w/2)) / w, d = r_d / rn
    (``dist`` is (F, 1) = the field-of-view angle w).

    Both are even in rn: d -> 2 T / w and d'/rn -> -16 T^3 / (3 w) as
    rn -> 0 (T = tan(w/2)); the small-s branch uses the Taylor
    expansion with the standard double-where guard. A (near-)zero w is
    the pinhole limit (d -> 1, no curvature): guarded explicitly since
    w divides everything."""
    w = dist[:, 0][None]
    t = jnp.tan(0.5 * jnp.where(jnp.abs(w) < 1e-6, 1.0, w))
    small = s < 1e-12
    s_safe = jnp.where(small, 1.0, s)
    rn = jnp.sqrt(s_safe)
    a = jnp.arctan2(2.0 * rn * t, jnp.ones_like(rn))
    w_safe = jnp.where(jnp.abs(w) < 1e-6, 1.0, w)
    d_exact = a / (w_safe * rn)
    ap = 2.0 * t / (1.0 + 4.0 * t * t * s_safe)  # dA/drn
    wu_exact = (ap * rn - a) / (w_safe * s_safe * rn)
    d0 = 2.0 * t / w_safe
    d_taylor = d0 * (1.0 - (4.0 / 3.0) * t * t * s)
    wu_taylor = -(16.0 / 3.0) * t**3 / w_safe
    d = jnp.where(small, d_taylor, d_exact)
    wu = jnp.where(small, wu_taylor, wu_exact)
    pinhole = jnp.abs(w) < 1e-6
    d = jnp.where(pinhole, 1.0, d)
    wu = jnp.where(pinhole, 0.0, wu)
    return d, wu


def _fov_domega(s: jax.Array, dist: jax.Array) -> jax.Array:
    """dd/dw of the FOV scale at fixed geometry — the regressor of the
    scalar Gauss-Newton refit. Exact: dd/dw = (1 + T^2) /
    (w (1 + 4 T^2 s)) - A / (w^2 rn), finite at rn -> 0 (A/rn -> 2T)
    and at w -> 0 (pinhole: 0 to first order)."""
    w = dist[:, 0][None]
    w_safe = jnp.where(jnp.abs(w) < 1e-6, 1.0, w)
    t = jnp.tan(0.5 * w_safe)
    small = s < 1e-12
    s_safe = jnp.where(small, 1.0, s)
    rn = jnp.sqrt(s_safe)
    a_over_rn = jnp.where(
        small, 2.0 * t, jnp.arctan2(2.0 * rn * t, jnp.ones_like(rn)) / rn
    )
    dd = (1.0 + t * t) / (w_safe * (1.0 + 4.0 * t * t * s_safe))         - a_over_rn / (w_safe * w_safe)
    return jnp.where(jnp.abs(w) < 1e-6, 0.0, dd)


_FOV_GN_STEPS = 6


def _fov_gn_terms(state: BAState, p, q, r, x, vis, f0: float,
                  dist: jax.Array):
    """(F, 2) = (gradient numerator, GN denominator) accumulands of one
    scalar Gauss-Newton step on the FOV angle — a per-point sum, so
    every core's accumulation machinery applies."""
    r = jnp.where(vis > 0, r, jnp.ones_like(r))
    g1 = p / r - (state.u[:, 0] / f0)[None]
    g2 = q / r - (state.u[:, 1] / f0)[None]
    s = ((f0 / state.f) ** 2)[None] * (g1 * g1 + g2 * g2)
    t1 = x[..., 0] / f0 - (state.u[:, 0] / f0)[None]
    t2 = x[..., 1] / f0 - (state.u[:, 1] / f0)[None]
    d, _ = _fov_scale(s, dist)
    dd = _fov_domega(s, dist)
    res1 = t1 - d * g1
    res2 = t2 - d * g2
    num = jnp.sum(vis * dd * (res1 * g1 + res2 * g2), axis=0)
    den = jnp.sum(vis * dd * dd * (g1 * g1 + g2 * g2), axis=0)
    return jnp.stack([num, den], axis=-1)  # (F, 2)


def _solve_fov_step(terms: jax.Array, dist: jax.Array,
                    shared: bool) -> jax.Array:
    """One GN update w += num/den from the accumulated (F, 2) terms
    (degenerate cameras keep their angle)."""
    nf = terms.shape[0]
    if shared:
        terms = jnp.broadcast_to(
            jnp.sum(terms, axis=0, keepdims=True), (nf, 2)
        )
    num, den = terms[:, 0], terms[:, 1]
    tiny = jnp.asarray(np.finfo(np.dtype(terms.dtype)).tiny, terms.dtype)
    safe = den > tiny
    step = jnp.where(safe, num / jnp.where(safe, den, 1.0), 0.0)
    new = dist[:, 0] + step
    ok = safe & jnp.isfinite(new)
    return jnp.where(ok, new, dist[:, 0])[:, None]


def _thin_prism_terms(state: BAState, g1, g2, f0: float, dist):
    """Per-observation quantities of COLMAP's THIN_PRISM_FISHEYE model
    (model 10): the equidistant base psi = (theta/|x_n|) x_n followed by
    an OPENCV-style polynomial + thin-prism shift *in the theta-plane*::

        rho2   = |psi|^2 = theta^2
        radial = k1 rho2 + k2 rho2^2 + k3 rho2^3 + k4 rho2^4
        du1    = psi1 radial + 2 p1 psi1 psi2 + p2 (rho2 + 2 psi1^2)
                 + sx1 rho2
        du2    = psi2 radial + p1 (rho2 + 2 psi2^2) + 2 p2 psi1 psi2
                 + sy1 rho2

    ``dist`` is (F, 8) = (k1, k2, k3, k4, p1, p2, sx1, sy1). Returns
    (m0, wu0, psi1, psi2, du1, du2, J11, J12, J21, J22, s) with
    (m0, wu0) the k = 0 fisheye base scale/weight at s = |x_n|^2 and J
    the (asymmetric — sx1/sy1 break the symmetry) 2x2 Jacobian of the
    shift wrt psi."""
    c = (f0 / state.f)[None]
    s = c * c * (g1 * g1 + g2 * g2)
    m0, wu0 = _fisheye_scale(s, jnp.zeros((state.f.shape[0], 4), g1.dtype))
    psi1 = m0 * c * g1
    psi2 = m0 * c * g2
    rho2 = psi1 * psi1 + psi2 * psi2  # = theta^2
    k1 = dist[:, 0][None]
    k2 = dist[:, 1][None]
    k3 = dist[:, 2][None]
    k4 = dist[:, 3][None]
    p1 = dist[:, 4][None]
    p2 = dist[:, 5][None]
    sx1 = dist[:, 6][None]
    sy1 = dist[:, 7][None]
    radial = rho2 * (k1 + rho2 * (k2 + rho2 * (k3 + rho2 * k4)))
    dradial = k1 + rho2 * (2.0 * k2 + rho2 * (3.0 * k3 + rho2 * (4.0 * k4)))
    du1 = psi1 * radial + 2.0 * p1 * psi1 * psi2         + p2 * (rho2 + 2.0 * psi1 * psi1) + sx1 * rho2
    du2 = psi2 * radial + p1 * (rho2 + 2.0 * psi2 * psi2)         + 2.0 * p2 * psi1 * psi2 + sy1 * rho2
    two_dr = 2.0 * dradial
    j11 = radial + psi1 * two_dr * psi1 + 2.0 * p1 * psi2         + 6.0 * p2 * psi1 + 2.0 * sx1 * psi1
    j12 = psi1 * two_dr * psi2 + 2.0 * p1 * psi1 + 2.0 * p2 * psi2         + 2.0 * sx1 * psi2
    j21 = psi2 * two_dr * psi1 + 2.0 * p1 * psi1 + 2.0 * p2 * psi2         + 2.0 * sy1 * psi1
    j22 = radial + psi2 * two_dr * psi2 + 6.0 * p1 * psi2         + 2.0 * p2 * psi1 + 2.0 * sy1 * psi2
    return m0, wu0, psi1, psi2, du1, du2, j11, j12, j21, j22, s


def _rational_scale(s: jax.Array, dist: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(d, 2 dd/ds) of the OpenCV rational model at s = |rho|^2:
    d = N/D with N = 1 + k1 s + k2 s^2 + k3 s^3,
    D = 1 + k4 s + k5 s^2 + k6 s^3 (``dist`` is (F, 8) =
    (k1..k6, p1, p2)). dd/ds = (N' D - N D') / D^2 — exact, no special
    cases (D = 1 at the principal point)."""
    k = [dist[:, i][None] for i in range(6)]
    num = 1.0 + s * (k[0] + s * (k[1] + s * k[2]))
    den = 1.0 + s * (k[3] + s * (k[4] + s * k[5]))
    dnum = k[0] + s * (2.0 * k[1] + s * (3.0 * k[2]))
    dden = k[3] + s * (2.0 * k[4] + s * (3.0 * k[5]))
    d = num / den
    wu = 2.0 * (dnum * den - num * dden) / (den * den)
    return d, wu


def _fisheye_scale(s: jax.Array, dist: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(m, m'/rn) of the equidistant theta-polynomial at rn = sqrt(s)
    (rn = |rho|, the normalized-ray radius).

    With theta = atan(rn) and theta_d = theta P(theta^2),
    P(y) = 1 + k1 y + k2 y^2 + k3 y^3 + k4 y^4:
      m     = theta_d / rn
      m'/rn = (theta_d'(theta) / (1 + rn^2) - m) / rn^2
    Both are even in rn with finite limits m -> 1,
    m'/rn -> 2 (k1 - 1/3) at rn -> 0; the small-s branch uses the
    quadratic Taylor expansion and the exact branch clamps s away from
    zero so reverse-mode autodiff through the unused branch stays
    finite (the standard double-where guard)."""
    k1 = dist[:, 0][None]
    k2 = dist[:, 1][None]
    k3 = dist[:, 2][None]
    k4 = dist[:, 3][None]
    small = s < 1e-12
    s_safe = jnp.where(small, 1.0, s)
    rn = jnp.sqrt(s_safe)
    th = jnp.arctan(rn)
    th2 = th * th
    poly = 1.0 + th2 * (k1 + th2 * (k2 + th2 * (k3 + th2 * k4)))
    dpoly = k1 + th2 * (2.0 * k2 + th2 * (3.0 * k3 + th2 * (4.0 * k4)))
    thd = th * poly
    dthd = poly + 2.0 * th2 * dpoly  # d theta_d / d theta
    m_exact = thd / rn
    wu_exact = (dthd / (1.0 + s_safe) - m_exact) / s_safe
    c0 = k1 - (1.0 / 3.0)
    m = jnp.where(small, 1.0 + c0 * s, m_exact)
    wu = jnp.where(small, 2.0 * c0, wu_exact)
    return m, wu


def _tangential_terms(state: BAState, g1, g2, f0: float, dist):
    """Per-observation tangential-distortion quantities (the OPENCV
    (p1, p2) model; ``dist`` is (F, 4) = (k1, k2, p1, p2)).

    In normalized-ray coords x_n = (f0/f) g the OPENCV tangential shift
    is (2 p1 XY + p2 (r^2 + 2X^2), p1 (r^2 + 2Y^2) + 2 p2 XY); mapped to
    f0-normalized image coordinates (pi~ adds (f/f0) * shift) it becomes
    c * h(g) with c = f0/f. Returns the shift (t1, t2) and its symmetric
    Jacobian wrt g (T11, T12, T22), which adds onto the radial 2x2
    chain; the only extra explicit camera dependence is c's 1/f (handled
    by the -t/f term in the f column)."""
    c = (f0 / state.f)[None]
    pcol = 6 if dist.shape[-1] == 8 else 2
    p1 = dist[:, pcol][None]
    p2 = dist[:, pcol + 1][None]
    g11, g22, g12 = g1 * g1, g2 * g2, g1 * g2
    t1 = c * (2.0 * p1 * g12 + p2 * (3.0 * g11 + g22))
    t2 = c * (p1 * (g11 + 3.0 * g22) + 2.0 * p2 * g12)
    t11 = 2.0 * c * (p1 * g2 + 3.0 * p2 * g1)
    t12 = 2.0 * c * (p1 * g1 + p2 * g2)
    t22 = 2.0 * c * (3.0 * p1 * g2 + p2 * g1)
    return t1, t2, t11, t12, t22


def _apply_distortion_chain(
    state: BAState, p, q, r, f0: float, dist, res_p, res_q, a1, a2, b1, b2,
    model: str | None = None,
):
    """Distortion transform of the residuals and the rank-2 Jacobian
    factors (shared by the dense and chunked derivative builds; leading
    axis is P or a chunk C).

    Distorted prediction pi~ = d g + u/f0 (+ the tangential shift
    t(g) under the OPENCV model), with (d, wu) the model's radial scale
    and chain weight (``_distortion_terms``). The residual gains
    (d - 1) g (+ t); the factor rows chain through the 2x2 Jacobian
    D = d I + wu (f0/f)^2 g g^T (+ dt/dg, also symmetric), which
    applies verbatim to the point rows (a). The camera rows (b) differ
    from dg/dtheta in exactly two places: the u columns (dg/du =
    dpi/du - 1/f0, and pi~ adds its own +1/f0 back) and the f column
    (s and c depend on f directly: dpi~/df gains -(wu s / f) g - t/f)."""
    model = resolve_distortion_model(dist, model)
    if model == "thin_prism":
        return _apply_thin_prism_chain(
            state, p, q, r, f0, dist, res_p, res_q, a1, a2, b1, b2
        )
    g1, g2, s, d, wu = _distortion_terms(state, p, q, r, f0, dist, model)
    tangential = model in ("opencv", "full_opencv")
    res_p = res_p + (d - 1.0) * g1
    res_q = res_q + (d - 1.0) * g2
    cw = wu * (f0 / state.f)[None] ** 2
    d11 = d + cw * g1 * g1
    d12 = cw * g1 * g2
    d22 = d + cw * g2 * g2
    if tangential:
        t1, t2, t11, t12, t22 = _tangential_terms(state, g1, g2, f0, dist)
        res_p = res_p + t1
        res_q = res_q + t2
        d11 = d11 + t11
        d12 = d12 + t12
        d22 = d22 + t22
    a1, a2 = (
        d11[..., None] * a1 + d12[..., None] * a2,
        d12[..., None] * a1 + d22[..., None] * a2,
    )
    inv_f0 = jnp.asarray(1.0 / f0, b1.dtype)
    b1 = b1.at[..., 1].add(-inv_f0)  # b -> dg/dtheta (u columns only)
    b2 = b2.at[..., 2].add(-inv_f0)
    b1, b2 = (
        d11[..., None] * b1 + d12[..., None] * b2,
        d12[..., None] * b1 + d22[..., None] * b2,
    )
    b1 = b1.at[..., 1].add(inv_f0)  # + d(u/f0)/du
    b2 = b2.at[..., 2].add(inv_f0)
    cf = wu * s / state.f[None]  # -(wu s / f) g on the f column
    b1 = b1.at[..., 0].add(-cf * g1)
    b2 = b2.at[..., 0].add(-cf * g2)
    if tangential:
        inv_f = (1.0 / state.f)[None]  # -t/f: c = f0/f explicit in t
        b1 = b1.at[..., 0].add(-t1 * inv_f)
        b2 = b2.at[..., 0].add(-t2 * inv_f)
    return res_p, res_q, a1, a2, b1, b2


def _apply_thin_prism_chain(
    state: BAState, p, q, r, f0: float, dist, res_p, res_q, a1, a2, b1, b2
):
    """THIN_PRISM_FISHEYE chain: the prediction composes the equidistant
    base with the theta-plane polynomial/prism shift (``_thin_prism_
    terms``), so the 2x2 Jacobian is the *asymmetric* product
    D = (I + J_du(psi)) @ M with M = m0 I + wu0 (f0/f)^2 g g^T, and the
    explicit f-column correction is G~/f - (I + J_du) g / (f (1 + s))
    (G~ = the distorted g-part; reduces exactly to the fisheye formula
    at zero shift)."""
    g1 = p / r - (state.u[:, 0] / f0)[None]
    g2 = q / r - (state.u[:, 1] / f0)[None]
    (m0, wu0, psi1, psi2, du1, du2,
     j11, j12, j21, j22, s) = _thin_prism_terms(state, g1, g2, f0, dist)
    inv_c = (state.f / f0)[None]  # 1/c: theta-plane -> image coords
    dug1 = du1 * inv_c
    dug2 = du2 * inv_c
    res_p = res_p + (m0 - 1.0) * g1 + dug1
    res_q = res_q + (m0 - 1.0) * g2 + dug2
    cw = wu0 * (f0 / state.f)[None] ** 2
    m11 = m0 + cw * g1 * g1
    m12 = cw * g1 * g2
    m22 = m0 + cw * g2 * g2
    d11 = (1.0 + j11) * m11 + j12 * m12
    d12 = (1.0 + j11) * m12 + j12 * m22
    d21 = j21 * m11 + (1.0 + j22) * m12
    d22 = j21 * m12 + (1.0 + j22) * m22
    a1, a2 = (
        d11[..., None] * a1 + d12[..., None] * a2,
        d21[..., None] * a1 + d22[..., None] * a2,
    )
    inv_f0 = jnp.asarray(1.0 / f0, b1.dtype)
    b1 = b1.at[..., 1].add(-inv_f0)  # b -> dg/dtheta (u columns only)
    b2 = b2.at[..., 2].add(-inv_f0)
    b1, b2 = (
        d11[..., None] * b1 + d12[..., None] * b2,
        d21[..., None] * b1 + d22[..., None] * b2,
    )
    b1 = b1.at[..., 1].add(inv_f0)  # + d(u/f0)/du
    b2 = b2.at[..., 2].add(inv_f0)
    inv_f = (1.0 / state.f)[None]
    damp = inv_f / (1.0 + s)
    gt1 = m0 * g1 + dug1  # the distorted g-part G~
    gt2 = m0 * g2 + dug2
    ijg1 = (1.0 + j11) * g1 + j12 * g2
    ijg2 = j21 * g1 + (1.0 + j22) * g2
    b1 = b1.at[..., 0].add(gt1 * inv_f - ijg1 * damp)
    b2 = b2.at[..., 0].add(gt2 * inv_f - ijg2 * damp)
    return res_p, res_q, a1, a2, b1, b2


def _distorted_residual(state: BAState, p, q, r, x, f0: float, dist,
                        model: str | None = None):
    """(res_p, res_q) through the distortion model from sanitized
    (p, q, r) — the shared trial-error expression of the dense and
    chunked cores."""
    res_p = p / r - x[..., 0] / f0
    res_q = q / r - x[..., 1] / f0
    if dist is not None:
        model = resolve_distortion_model(dist, model)
        g1 = p / r - (state.u[:, 0] / f0)[None]
        g2 = q / r - (state.u[:, 1] / f0)[None]
        if model == "thin_prism":
            m0, _, _, _, du1, du2, *_ = _thin_prism_terms(
                state, g1, g2, f0, dist
            )
            inv_c = (state.f / f0)[None]
            res_p = res_p + (m0 - 1.0) * g1 + du1 * inv_c
            res_q = res_q + (m0 - 1.0) * g2 + du2 * inv_c
            return res_p, res_q
        _, _, _, d, _ = _distortion_terms(state, p, q, r, f0, dist, model)
        res_p = res_p + (d - 1.0) * g1
        res_q = res_q + (d - 1.0) * g2
        if model in ("opencv", "full_opencv"):
            t1, t2, _, _, _ = _tangential_terms(state, g1, g2, f0, dist)
            res_p = res_p + t1
            res_q = res_q + t2
    return res_p, res_q


@dataclasses.dataclass(frozen=True)
class _Derivs:
    """Per-outer-iteration derivative tensors (reference ``:106-116``)."""

    d_P: jax.Array  # (P, 3) gradient wrt points
    d_F: jax.Array  # (9F,) gradient wrt cameras (gauge-masked)
    matE: jax.Array  # (P, 3, 3) point blocks
    matF: jax.Array  # (P, 3, 9F) coupling blocks (gauge-masked columns)
    matG: jax.Array  # (F, 9, 9) camera blocks


def _camera_param_derivs(
    state: BAState, p: jax.Array, q: jax.Array, r: jax.Array, f0: float
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """(dp, dq, dr)/d(f, u0, v0, t, omega): (P, F, 9) each
    (reference ``:324-427``)."""
    f, u, t, R, X = state.f, state.u, state.t, state.R, state.X
    npts = X.shape[0]
    nf = f.shape[0]

    # d/df (reference ``:324-340``)
    dpdf = (p - (u[:, 0] / f0)[None] * r) / f[None]
    dqdf = (q - (u[:, 1] / f0)[None] * r) / f[None]
    drdf = jnp.zeros_like(dpdf)

    # d/du (reference ``:342-358``)
    r_over_f0 = r / f0
    zeros = jnp.zeros_like(r_over_f0)
    dpdu = jnp.stack([r_over_f0, zeros], axis=-1)
    dqdu = jnp.stack([zeros, r_over_f0], axis=-1)
    drdu = jnp.zeros_like(dpdu)

    # d/dt: per-image constants (reference ``:360-378``), broadcast not tiled
    dpdt_f = -(f[:, None] * R[:, :, 0] + u[:, :1] * R[:, :, 2])  # (F, 3)
    dqdt_f = -(f[:, None] * R[:, :, 1] + u[:, 1:2] * R[:, :, 2])
    drdt_f = -f0 * R[:, :, 2]

    # d/domega = cross(-d/dt, X - t) (reference ``:380-398``)
    x_minus_t = X[:, None, :] - t[None, :, :]  # (P, F, 3)
    dpdw = jnp.cross(-dpdt_f[None], x_minus_t)
    dqdw = jnp.cross(-dqdt_f[None], x_minus_t)
    drdw = jnp.cross(-drdt_f[None], x_minus_t)

    dpdt = jnp.broadcast_to(dpdt_f[None], (npts, nf, 3))
    dqdt = jnp.broadcast_to(dqdt_f[None], (npts, nf, 3))
    drdt = jnp.broadcast_to(drdt_f[None], (npts, nf, 3))

    dp = jnp.concatenate([dpdf[..., None], dpdu, dpdt, dpdw], axis=-1)
    dq = jnp.concatenate([dqdf[..., None], dqdu, dqdt, dqdw], axis=-1)
    dr = jnp.concatenate([drdf[..., None], drdu, drdt, drdw], axis=-1)
    return dp, dq, dr


def _psum(v: jax.Array, axis_name: str | None) -> jax.Array:
    """Cross-device reduction over the points axis (no-op single-device).

    This is the framework's entire "communication backend" for BA: per-point
    partial sums of camera-side quantities (d_F, matG, the Schur system, the
    scalar error) reduce over the ``points`` mesh axis; XLA lowers the psum
    to an all-reduce (NCCL between GPUs). Everything else stays
    device-local.
    """
    return v if axis_name is None else jax.lax.psum(v, axis_name)


def _compute_derivs(
    state: BAState,
    x: jax.Array,
    vis: jax.Array,
    free: jax.Array,
    f0: float,
    axis_name: str | None = None,
    dist: jax.Array | None = None,
    model: str | None = None,
) -> tuple[_Derivs, jax.Array]:
    """All first/second derivative blocks for one outer LM iteration
    (reference ``:102-116``). Returns (derivs, current E).

    With ``axis_name`` set (inside shard_map over points), the camera-side
    sums (d_F, matG, E) are psum-reduced; point-side blocks stay local.

    With ``dist`` (any supported family — resolve_distortion_model /
    ``model``) the residual becomes the distorted one and the Jacobian
    factors are chained through the exact 2x2 distortion Jacobian
    (symmetric D = d I + wu (f0/f)^2 g g^T for the single-stage models;
    the asymmetric two-stage product for thin_prism) — the rank-2
    outer-product structure every downstream Schur path exploits is
    preserved, so distortion costs only elementwise work."""
    npts, nf = x.shape[0], state.f.shape[0]
    K = build_K(state.f, state.u, f0)
    pmat, p, q, r = calc_pqr(state.X, K, state.R, state.t)

    # dX derivatives are the camera-matrix rows (reference ``:309-322``).
    dpdX = pmat[:, 0, :3]  # (F, 3), broadcast over points
    dqdX = pmat[:, 1, :3]
    drdX = pmat[:, 2, :3]

    dpdc, dqdc, drdc = _camera_param_derivs(state, p, q, r, f0)  # (P, F, 9)

    # Invisible entries contribute nothing but must not poison the sums
    # (0 * inf = nan when a masked/padded point sits on a camera plane,
    # r = 0), so r is sanitized wherever vis == 0.
    r = jnp.where(vis > 0, r, jnp.ones_like(r))
    res_p = p / r - x[..., 0] / f0  # (P, F)
    res_q = q / r - x[..., 1] / f0

    # Jacobian blocks scaled by 1/r^2 (folded into the factors so every
    # second-derivative block is a plain product of two tensors):
    #   a1 = (r * dp/dX - p * dr/dX) / r^2,   a2 = likewise for q
    #   b1 = (r * dp/dc - p * dr/dc) / r^2,   b2 = likewise for q
    inv_r2 = 1.0 / (r * r)
    a1 = (r[..., None] * dpdX[None] - p[..., None] * drdX[None]) * inv_r2[..., None]
    a2 = (r[..., None] * dqdX[None] - q[..., None] * drdX[None]) * inv_r2[..., None]
    b1 = (r[..., None] * dpdc - p[..., None] * drdc) * inv_r2[..., None]
    b2 = (r[..., None] * dqdc - q[..., None] * drdc) * inv_r2[..., None]

    if dist is not None:
        res_p, res_q, a1, a2, b1, b2 = _apply_distortion_chain(
            state, p, q, r, f0, dist, res_p, res_q, a1, a2, b1, b2, model
        )

    e_now = _psum(jnp.sum(vis * (res_p**2 + res_q**2)), axis_name)

    visf = vis[..., None]

    # Gradients (reference _calc_d_P ``:429-469``, _calc_d_F ``:471-517``).
    d_P = 2.0 * jnp.sum(visf * (res_p[..., None] * a1 + res_q[..., None] * a2), axis=1)
    d_F = 2.0 * jnp.sum(visf * (res_p[..., None] * b1 + res_q[..., None] * b2), axis=0)
    d_F = _psum(d_F.reshape(9 * nf), axis_name) * free

    # Gauss-Newton blocks. The reference divides the outer products by r^4
    # (``:554, :605, :653``); with the 1/r^2 folded into a*, b* above the
    # scale factors multiply to exactly r^-4.
    vw = visf[..., None]
    matE = 2.0 * jnp.sum(vw * jnp.einsum("pfi,pfj->pfij", a1, a1, precision=HIGHEST)
                         + vw * jnp.einsum("pfi,pfj->pfij", a2, a2, precision=HIGHEST), axis=1)
    matG = 2.0 * jnp.sum(vw * jnp.einsum("pfi,pfj->pfij", b1, b1, precision=HIGHEST)
                         + vw * jnp.einsum("pfi,pfj->pfij", b2, b2, precision=HIGHEST), axis=0)
    matG = _psum(matG, axis_name)

    # Points with no visible observation (padding under point-sharding)
    # get an identity E block so the Schur elimination stays well-posed and
    # their update is exactly zero.
    seen = (jnp.sum(vis, axis=1) > 0).astype(matE.dtype)  # (P,)
    matE = matE + (1.0 - seen)[:, None, None] * jnp.eye(3, dtype=matE.dtype)
    matF_blocks = 2.0 * (
        vw * jnp.einsum("pfi,pfj->pfij", a1, b1, precision=HIGHEST)
        + vw * jnp.einsum("pfi,pfj->pfij", a2, b2, precision=HIGHEST)
    )  # (P, F, 3, 9)
    matF = matF_blocks.transpose(0, 2, 1, 3).reshape(npts, 3, 9 * nf)
    matF = matF * free[None, None, :]

    return _Derivs(d_P=d_P, d_F=d_F, matE=matE, matF=matF, matG=matG), e_now


def _camera_side_solve(
    derivs: _Derivs, matEc: jax.Array, matGc: jax.Array, free: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Camera-block elimination of the same damped system: exact flipped
    Schur complement for the 3P < 9F regime (the batched-scenes shape:
    P = 200 points x F = 100 views makes the usual point-side reduced
    camera system (9F, 9F) the *larger* block). The camera block is
    9x9-block-diagonal, so its inverse is closed form (``inv9_spd`` —
    no custom call), and the dense solve shrinks from (9F, 9F) to
    (3P, 3P). Same algebra as the reference's Schur
    complement (``bundle_adjustment.py:118-152``) from the other side;
    fp-identical gauge semantics (fixed params move exactly zero).
    """
    npts = derivs.matE.shape[0]
    nf9 = derivs.matF.shape[2]
    nf = nf9 // 9
    dt = derivs.matE.dtype

    # Gauge: identity rows/cols on fixed camera params (matF columns and
    # d_F are already masked by the derivative build).
    free_b = free.reshape(nf, 9)
    matGm = matGc * (free_b[:, :, None] * free_b[:, None, :])
    matGm = matGm + jnp.eye(9, dtype=dt) * (1.0 - free_b)[:, :, None]
    ginv = inv9_spd(matGm)  # (F, 9, 9), closed form

    fc = derivs.matF.reshape(npts, 3, nf, 9)
    h = jnp.einsum("pifa,fab->pifb", fc, ginv, precision=jax.lax.Precision.HIGH)
    s4 = jnp.einsum("pifa,qjfa->piqj", h, fc, precision=jax.lax.Precision.HIGH)
    idx = jnp.arange(npts)
    s4 = (-s4).at[idx, :, idx, :].add(matEc)
    s = s4.reshape(npts * 3, npts * 3)

    gd = jnp.einsum("fab,fb->fa", ginv, derivs.d_F.reshape(nf, 9), precision=HIGHEST)
    rhs = -derivs.d_P + jnp.einsum("pifa,fa->pi", fc, gd, precision=HIGHEST)

    dx = jax.scipy.linalg.cho_solve(
        jax.scipy.linalg.cho_factor(s), rhs.reshape(npts * 3)
    )
    delta_x = dx.reshape(npts, 3)

    ftdx = jnp.einsum("pifa,pi->fa", fc, delta_x, precision=HIGHEST)
    delta_xi = -jnp.einsum(
        "fab,fb->fa", ginv, derivs.d_F.reshape(nf, 9) + ftdx, precision=HIGHEST
    ).reshape(nf9)
    return delta_xi * free, delta_x


def _damped_solve(
    derivs: _Derivs, c: jax.Array, free: jax.Array, axis_name: str | None = None
) -> tuple[jax.Array, jax.Array]:
    """Solve the damped normal equations by the point-block Schur
    complement (reference inner loop ``:118-152``).

    Returns (delta_xi (9F,), delta_X (P, 3)). Gauge-fixed entries of
    delta_xi are exactly zero (identity rows in the masked system).

    Side selection: when the point block is the smaller one (3P < 9F)
    and points are not sharded, the camera block is eliminated instead
    (``_camera_side_solve``) — same system, smaller dense solve.
    """
    npts = derivs.matE.shape[0]
    nf9 = derivs.matF.shape[2]
    dt = derivs.matE.dtype

    # Damp block diagonals by (1 + c) (reference ``:119-125``).
    eye3 = jnp.eye(3, dtype=dt)
    matEc = derivs.matE + c * derivs.matE * eye3[None]
    eye9 = jnp.eye(9, dtype=dt)
    matGc = derivs.matG + c * derivs.matG * eye9[None]

    if axis_name is None and npts * 3 < nf9:
        return _camera_side_solve(derivs, matEc, matGc, free)

    a, b, einv = reduced_camera_system(derivs, matEc, matGc, free, axis_name)

    # The damped, gauge-projected reduced system is SPD -> Cholesky.
    delta_xi = jax.scipy.linalg.cho_solve(
        jax.scipy.linalg.cho_factor(a), b
    )
    delta_xi = delta_xi * free  # exact zeros on fixed params

    # Back-substitute point updates (reference ``:152``).
    rhs = jnp.einsum("pxm,m->px", derivs.matF, delta_xi, precision=HIGHEST) + derivs.d_P
    delta_x = -jnp.einsum("pxy,py->px", einv, rhs, precision=HIGHEST)
    return delta_xi, delta_x


def reduced_camera_system(
    derivs: _Derivs, matEc: jax.Array, matGc: jax.Array, free: jax.Array,
    axis_name: str | None = None,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Point-eliminated (Schur) camera system of the damped normal
    equations (reference ``:118-150``): returns (A (9F, 9F) with the
    gauge projection, b (9F,), Einv (P, 3, 3))."""
    npts = derivs.matE.shape[0]
    nf9 = derivs.matF.shape[2]
    einv = inv3x3(matEc)  # (P, 3, 3)
    einv_f = jnp.einsum("pxy,pym->pxm", einv, derivs.matF, precision=HIGHEST)  # (P, 3, 9F)

    # Reduced camera system: A = blockdiag(Gc) - sum_p F^T Einv F as one
    # (9F, 3P) @ (3P, 9F) matmul.
    fmat = derivs.matF.reshape(npts * 3, nf9)
    einv_fmat = einv_f.reshape(npts * 3, nf9)
    schur = _psum(jnp.einsum("km,kn->mn", fmat, einv_fmat, precision=HIGHEST), axis_name)

    nf = nf9 // 9
    a = -schur
    a = a.reshape(nf, 9, nf, 9)
    idx = jnp.arange(nf)
    a = a.at[idx, :, idx, :].add(matGc)
    a = a.reshape(nf9, nf9)

    # Project out gauge-fixed params: identity rows/cols, zero rhs.
    free2d = free[:, None] * free[None, :]
    a = a * free2d + jnp.diag(1.0 - free)

    b = _psum(jnp.einsum("pxm,px->m", einv_f, derivs.d_P, precision=HIGHEST), axis_name)
    return a, b - derivs.d_F, einv


def _predicted_reduction(
    derivs: _Derivs, delta_xi: jax.Array, delta_x: jax.Array, c: jax.Array,
    axis_name: str | None = None,
) -> jax.Array:
    """Predicted decrease of the damped quadratic model,
    1/2 (c * d^T D d - g^T d) with D = diag(H) (Marquardt scaling) —
    the denominator of the Nielsen gain ratio."""
    diag_e = jnp.diagonal(derivs.matE, axis1=-2, axis2=-1)  # (P, 3)
    dDd_pts = jnp.sum(delta_x * diag_e * delta_x)
    g_d_pts = jnp.sum(derivs.d_P * delta_x)
    diag_g = jnp.diagonal(derivs.matG, axis1=-2, axis2=-1).reshape(-1)  # (9F,)
    dDd = _psum(dDd_pts, axis_name) + jnp.sum(delta_xi * diag_g * delta_xi)
    g_d = _psum(g_d_pts, axis_name) + jnp.sum(derivs.d_F * delta_xi)
    return 0.5 * (c * dDd - g_d)


def _apply_update(state: BAState, delta_xi: jax.Array, delta_x: jax.Array) -> BAState:
    """Parameter update; rotations via the axis-angle exponential
    (reference ``_update_camera_params``, ``:263-281``)."""
    nf = state.f.shape[0]
    d = delta_xi.reshape(nf, 9)
    delta_r = rodrigues(d[:, 6:9])
    return BAState(
        X=state.X + delta_x,
        f=state.f + d[:, 0],
        u=state.u + d[:, 1:3],
        t=state.t + d[:, 3:6],
        R=jnp.matmul(delta_r, state.R, precision=STATE_HIGHEST),
    )


def _residuals(
    state: BAState, x: jax.Array, vis: jax.Array, f0: float,
    dist: jax.Array | None = None, model: str | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Per-observation (res_p, res_q), optionally through the radial
    distortion model (masked entries sanitized)."""
    K = build_K(state.f, state.u, f0)
    _, p, q, r = calc_pqr(state.X, K, state.R, state.t)
    r = jnp.where(vis > 0, r, jnp.ones_like(r))
    return _distorted_residual(state, p, q, r, x, f0, dist, model)


def _state_error(
    state: BAState, x: jax.Array, vis: jax.Array, f0: float,
    axis_name: str | None = None, dist: jax.Array | None = None,
    model: str | None = None,
) -> jax.Array:
    res_p, res_q = _residuals(state, x, vis, f0, dist, model)
    return _psum(jnp.sum(vis * (res_p**2 + res_q**2)), axis_name)


ROBUST_LOSSES = ("huber", "cauchy", "soft_l1", "arctan")


def resolve_robust(robust: str | None) -> str | None:
    """Normalize ``LMConfig.robust``: None / "" / "none" mean plain
    least squares (the reference contract; "none" is accepted for
    callers that spell the plain loss as a string), anything else must
    be a known loss kind."""
    if robust in (None, "", "none"):
        return None
    if robust not in ROBUST_LOSSES:
        raise ValueError(
            f"unknown robust loss: {robust!r} (use {ROBUST_LOSSES} or None)"
        )
    return robust


def robust_weight(mag: jax.Array, delta: float,
                  kind: str = "huber") -> jax.Array:
    """IRLS weight w = rho'(s) at s = mag^2 for the supported robust
    losses (the ceres LossFunction family; delta is the scale in
    residual-magnitude units):

    - huber:   rho' = min(1, delta/|r|) — quadratic core, linear tail
    - cauchy:  rho' = 1 / (1 + s/delta^2) — aggressive redescending
    - soft_l1: rho' = 1 / sqrt(1 + s/delta^2) — smooth pseudo-Huber
    - arctan:  rho' = 1 / (1 + (s/delta^2)^2) — hard redescending
      (bounded total influence)
    """
    if kind == "huber":
        return jnp.minimum(1.0, delta / jnp.maximum(mag, 1e-12))
    s_rel = (mag / delta) ** 2
    if kind == "cauchy":
        return 1.0 / (1.0 + s_rel)
    if kind == "soft_l1":
        return 1.0 / jnp.sqrt(1.0 + s_rel)
    if kind == "arctan":
        return 1.0 / (1.0 + s_rel * s_rel)
    raise ValueError(f"unknown robust loss: {kind!r} (use {ROBUST_LOSSES})")


def _huber_weights(
    state: BAState, x: jax.Array, vis: jax.Array, f0: float, delta: float,
    dist: jax.Array | None = None, model: str | None = None,
    robust_kind: str = "huber",
) -> jax.Array:
    """IRLS weights from the current residuals (``robust_weight`` of the
    normalized reprojection residual magnitude). Multiplied into the
    visibility mask, gross outliers stop dominating the normal
    equations."""
    res_p, res_q = _residuals(state, x, vis, f0, dist, model)
    mag = jnp.sqrt(res_p**2 + res_q**2)
    return vis * robust_weight(mag, delta, robust_kind)


def fit_distortion(
    state: BAState, x: jax.Array, vis: jax.Array, f0: float,
    shared: bool = False, axis_name: str | None = None,
    tangential: bool = False, model: str | None = None,
    dist: jax.Array | None = None,
) -> jax.Array:
    """Closed-form per-camera distortion refit.

    The BAL camera model's prediction ``pi~ = (1 + k1 s + k2 s^2) g +
    u/f0`` is *linear* in (k1, k2) given the geometry, so the
    least-squares-optimal distortion for the current state is an exact
    batched 2x2 normal-equation solve — no custom calls, no LM.
    Alternated with the geometry LM (``LMConfig.distortion_rounds``)
    this optimizes the full 9-parameter BAL camera (Rodrigues rotation,
    t, f, k1, k2; /root/reference has no distortion model — this covers
    the standard public BAL datasets' cameras). Degenerate cameras
    (all rays at the principal point) keep (0, 0).

    ``shared=True`` ties (k1, k2) across all cameras (one physical
    camera captured the sequence — the common video/turntable case):
    the per-camera normal equations sum into one global 2x2 system,
    which stays well-posed even when each frame alone sees too few
    rays to identify its own distortion.

    The (F, 5) normal terms are per-point sums, so under point sharding
    (``axis_name``) one psum completes them.

    ``tangential=True`` (equivalently ``model="opencv"``) fits the
    4-parameter OPENCV model (k1, k2, p1, p2) instead — the prediction
    is linear in all four, so the refit stays an exact closed-form
    solve, now per-camera 4x4 ((F, 20) normal terms, still a per-point
    sum). ``model="fisheye"`` fits the OPENCV_FISHEYE theta-polynomial
    (k1..k4): the prediction m0 (1 + sum k_i theta^(2i)) g + u/f0 is
    linear in k too, with basis vectors m0 theta^(2i) g against the
    target (x - u)/f0 - m0 g (m0 = theta/|rho|, the k = 0 equidistant
    base)."""
    if model is None:
        model = "opencv" if tangential else "radial"
    K = build_K(state.f, state.u, f0)
    _, p, q, r = calc_pqr(state.X, K, state.R, state.t)
    if model == "full_opencv":
        if dist is None:
            dist = jnp.zeros((state.f.shape[0], 8), x.dtype)
        for _ in range(FULL_OPENCV_ALTERNATIONS):
            for round_ in ("num", "den"):
                terms = _full_opencv_lsq_terms(
                    state, p, q, r, x, vis, f0, dist, round_
                )
                dist = _solve_full_opencv_round(
                    _psum(terms, axis_name), dist, round_, shared
                )
        return dist
    if model == "fov":
        # the FOV angle is the one model parameter that is NOT linear
        # in the prediction: a few scalar Gauss-Newton steps per camera
        # (still per-point-sum accumulands, still psum-completable)
        if dist is None:
            dist = jnp.full((state.f.shape[0], 1), 0.5, x.dtype)
        for _ in range(_FOV_GN_STEPS):
            terms = _fov_gn_terms(state, p, q, r, x, vis, f0, dist)
            dist = _solve_fov_step(_psum(terms, axis_name), dist, shared)
        return dist
    terms = _distortion_lsq_terms(state, p, q, r, x, vis, f0, model)
    return _solve_distortion_lsq(_psum(terms, axis_name), shared)


def _distortion_lsq_terms(state: BAState, p, q, r, x, vis, f0: float,
                          model="radial"):
    """Per-camera normal-equation accumulands of the linear-in-k
    distortion fit — a per-point sum, so the chunked core accumulates
    them over point chunks. (F, 5) = (a11, a12, a22, b1, b2) for the
    radial model; (F, 20) = (4x4 normal matrix rows, 4 rhs) for the
    4-parameter models (OPENCV (k1, k2, p1, p2) / OPENCV_FISHEYE
    k1..k4). ``model`` also accepts the legacy bool (tangential)."""
    if isinstance(model, bool):
        model = "opencv" if model else "radial"
    elif model is None:
        model = "radial"
    r = jnp.where(vis > 0, r, jnp.ones_like(r))
    g1 = p / r - (state.u[:, 0] / f0)[None]
    g2 = q / r - (state.u[:, 1] / f0)[None]
    s = ((f0 / state.f) ** 2)[None] * (g1 * g1 + g2 * g2)
    # target: (x/f0 - u/f0) - g = what the distortion shift must explain
    t1 = x[..., 0] / f0 - (state.u[:, 0] / f0)[None] - g1
    t2 = x[..., 1] / f0 - (state.u[:, 1] / f0)[None] - g2
    if model == "thin_prism":
        # the theta-plane shift is linear in all 8 parameters: basis
        # vectors in image coords are the x_n-plane regressors / c
        m0, _, psi1, psi2, *_ = _thin_prism_terms(
            state, g1, g2, f0, jnp.zeros((state.f.shape[0], 8), g1.dtype)
        )
        rho2 = psi1 * psi1 + psi2 * psi2
        # target shifts to (x - u)/f0 - m0 g (the k = 0 equidistant base)
        t1 = t1 + (1.0 - m0) * g1
        t2 = t2 + (1.0 - m0) * g2
        inv_c = (state.f / f0)[None]
        zero = jnp.zeros_like(rho2)
        A = jnp.stack([
            jnp.stack([rho2 * psi1, rho2 * psi2], axis=-1),
            jnp.stack([rho2**2 * psi1, rho2**2 * psi2], axis=-1),
            jnp.stack([rho2**3 * psi1, rho2**3 * psi2], axis=-1),
            jnp.stack([rho2**4 * psi1, rho2**4 * psi2], axis=-1),
            jnp.stack([2.0 * psi1 * psi2, rho2 + 2.0 * psi2**2], axis=-1),
            jnp.stack([rho2 + 2.0 * psi1**2, 2.0 * psi1 * psi2], axis=-1),
            jnp.stack([rho2, zero], axis=-1),
            jnp.stack([zero, rho2], axis=-1),
        ], axis=-2) * inv_c[..., None, None]  # (P, F, 8, 2), image coords
        T = jnp.stack([t1, t2], axis=-1)
        m = jnp.einsum("pfai,pfbi,pf->fab", A, A, vis, precision=HIGHEST)
        rhs = jnp.einsum("pfai,pfi,pf->fa", A, T, vis, precision=HIGHEST)
        return jnp.concatenate([m.reshape(-1, 64), rhs], axis=-1)  # (F, 72)
    if model == "fisheye":
        # basis m0 theta^(2i) g against target (x - u)/f0 - m0 g
        small = s < 1e-12
        s_safe = jnp.where(small, 1.0, s)
        rn = jnp.sqrt(s_safe)
        th = jnp.arctan(rn)
        m0 = jnp.where(small, 1.0 - s / 3.0, th / rn)
        t1 = t1 + (1.0 - m0) * g1  # target -= (m0 - 1) g
        t2 = t2 + (1.0 - m0) * g2
        th2 = jnp.where(small, s, th * th)
        base1, base2 = m0 * g1, m0 * g2
        A = jnp.stack([
            jnp.stack([th2 * base1, th2 * base2], axis=-1),
            jnp.stack([th2**2 * base1, th2**2 * base2], axis=-1),
            jnp.stack([th2**3 * base1, th2**3 * base2], axis=-1),
            jnp.stack([th2**4 * base1, th2**4 * base2], axis=-1),
        ], axis=-2)  # (P, F, 4, 2)
        T = jnp.stack([t1, t2], axis=-1)
        m = jnp.einsum("pfai,pfbi,pf->fab", A, A, vis, precision=HIGHEST)
        rhs = jnp.einsum("pfai,pfi,pf->fa", A, T, vis, precision=HIGHEST)
        return jnp.concatenate([m.reshape(-1, 16), rhs], axis=-1)  # (F, 20)
    if model == "radial":
        gg = g1 * g1 + g2 * g2
        gt = g1 * t1 + g2 * t2
        s2 = s * s
        return jnp.stack([
            jnp.sum(vis * s2 * gg, axis=0),
            jnp.sum(vis * s2 * s * gg, axis=0),
            jnp.sum(vis * s2 * s2 * gg, axis=0),
            jnp.sum(vis * s * gt, axis=0),
            jnp.sum(vis * s2 * gt, axis=0),
        ], axis=-1)  # (F, 5)
    # OPENCV regressors (each a 2-vector per observation): the shift is
    # k1 A1 + k2 A2 + p1 A3 + p2 A4 (see _tangential_terms for A3/A4).
    c = (f0 / state.f)[None]
    g11, g22, g12 = g1 * g1, g2 * g2, g1 * g2
    A = jnp.stack([
        jnp.stack([s * g1, s * g2], axis=-1),
        jnp.stack([s * s * g1, s * s * g2], axis=-1),
        jnp.stack([2.0 * c * g12, c * (g11 + 3.0 * g22)], axis=-1),
        jnp.stack([c * (3.0 * g11 + g22), 2.0 * c * g12], axis=-1),
    ], axis=-2)  # (P, F, 4, 2)
    T = jnp.stack([t1, t2], axis=-1)  # (P, F, 2)
    m = jnp.einsum("pfai,pfbi,pf->fab", A, A, vis, precision=HIGHEST)
    rhs = jnp.einsum("pfai,pfi,pf->fa", A, T, vis, precision=HIGHEST)
    return jnp.concatenate([m.reshape(-1, 16), rhs], axis=-1)  # (F, 20)


def _solve_distortion_lsq(terms: jax.Array, shared: bool) -> jax.Array:
    """Distortion from the accumulated normal terms: (F, 5) -> radial
    (F, 2); (F, 20) -> 4-parameter models; (F, 72) -> thin_prism
    (F, 8)."""
    if terms.shape[-1] == 72:
        return _solve_distortion_lsq_n(terms, 8, shared)
    if terms.shape[-1] == 20:
        return _solve_distortion_lsq4(terms, shared)
    nf = terms.shape[0]
    if shared:
        terms = jnp.broadcast_to(jnp.sum(terms, axis=0, keepdims=True), (nf, 5))
    a11, a12, a22, b1, b2 = (terms[:, i] for i in range(5))
    det = a11 * a22 - a12 * a12
    tiny = jnp.asarray(np.finfo(np.dtype(terms.dtype)).tiny, terms.dtype)
    safe = det > tiny
    det_s = jnp.where(safe, det, 1.0)
    k1 = jnp.where(safe, (b1 * a22 - b2 * a12) / det_s, 0.0)
    k2 = jnp.where(safe, (b2 * a11 - b1 * a12) / det_s, 0.0)
    return jnp.stack([k1, k2], axis=-1)


def _solve_distortion_lsq4(terms: jax.Array, shared: bool) -> jax.Array:
    """(F, 4) OPENCV distortion from the accumulated (F, 20) normal
    terms (4x4 SPD solve per camera; degenerate cameras keep zeros)."""
    return _solve_distortion_lsq_n(terms, 4, shared)


def _solve_distortion_lsq_n(terms: jax.Array, n: int,
                            shared: bool) -> jax.Array:
    """(F, n) distortion from accumulated (F, n^2 + n) normal terms
    (n x n SPD solve per camera; degenerate cameras keep zeros)."""
    nf = terms.shape[0]
    width = n * n + n
    if shared:
        terms = jnp.broadcast_to(
            jnp.sum(terms, axis=0, keepdims=True), (nf, width)
        )
    m = terms[:, : n * n].reshape(nf, n, n)
    rhs = terms[:, n * n:]
    tiny = jnp.asarray(np.finfo(np.dtype(terms.dtype)).tiny, terms.dtype)
    tr = jnp.trace(m, axis1=-2, axis2=-1)
    safe = tr > tiny
    m_s = jnp.where(safe[:, None, None], m, jnp.eye(n, dtype=m.dtype)[None])
    sol = jnp.linalg.solve(m_s, rhs[..., None])[..., 0]
    ok = safe & jnp.isfinite(sol).all(axis=-1)
    return jnp.where(ok[:, None], sol, 0.0)


# The rational model's prediction is NOT jointly linear in
# (k1..k6, p1, p2), but the D-cross-multiplied algebraic residual
# D (T - t) - N g = 0 is linear in (k1, k2, k3, p1, p2) given the
# denominator and linear in (k4, k5, k6) given the rest, so the refit
# alternates two exact vis-weighted linear solves. At zero residual
# (the exact-recovery contract) the alternation's fixed point is the
# generating distortion; with noise it minimizes the D-weighted
# algebraic loss — the standard rational-calibration convention.
FULL_OPENCV_ALTERNATIONS = 4


def _full_opencv_lsq_terms(state: BAState, p, q, r, x, vis, f0: float,
                           dist: jax.Array, round_: str):
    """(F, 30) normal-equation accumulands for one alternation round of
    the rational-model refit — a per-point sum, so the chunked/streamed/
    sharded cores accumulate it exactly like ``_distortion_lsq_terms``.
    ``round_`` = "num" (unknowns k1, k2, k3, p1, p2 with D frozen) or
    "den" (unknowns k4, k5, k6 with N, p frozen; regressors padded to
    the 5-basis layout so the accumuland shape is static)."""
    r = jnp.where(vis > 0, r, jnp.ones_like(r))
    g1 = p / r - (state.u[:, 0] / f0)[None]
    g2 = q / r - (state.u[:, 1] / f0)[None]
    s = ((f0 / state.f) ** 2)[None] * (g1 * g1 + g2 * g2)
    t1 = x[..., 0] / f0 - (state.u[:, 0] / f0)[None]  # target T
    t2 = x[..., 1] / f0 - (state.u[:, 1] / f0)[None]
    k = [dist[:, i][None] for i in range(6)]
    den = 1.0 + s * (k[3] + s * (k[4] + s * k[5]))
    c = (f0 / state.f)[None]
    g11, g22, g12 = g1 * g1, g2 * g2, g1 * g2
    h11, h12 = 2.0 * c * g12, c * (3.0 * g11 + g22)  # dt/dp1, dt/dp2
    h21, h22 = c * (g11 + 3.0 * g22), 2.0 * c * g12
    zeros = jnp.zeros_like(s)
    if round_ == "num":
        # D T - D t - N g = 0, t = p1 h_1 + p2 h_2:
        # [s g, s^2 g, s^3 g, D h_1, D h_2] a = D T - g
        A = jnp.stack([
            jnp.stack([s * g1, s * g2], axis=-1),
            jnp.stack([s * s * g1, s * s * g2], axis=-1),
            jnp.stack([s ** 3 * g1, s ** 3 * g2], axis=-1),
            jnp.stack([den * h11, den * h21], axis=-1),
            jnp.stack([den * h12, den * h22], axis=-1),
        ], axis=-2)  # (P, F, 5, 2)
        b1 = den * t1 - g1
        b2 = den * t2 - g2
    else:
        # N g + D (ts - T) = 0 with ts the tangential shift:
        # [s (ts - T), s^2 (ts - T), s^3 (ts - T)] b = (T - ts) - N g
        p1c = dist[:, 6][None]
        p2c = dist[:, 7][None]
        ts1 = p1c * h11 + p2c * h12
        ts2 = p1c * h21 + p2c * h22
        num = 1.0 + s * (k[0] + s * (k[1] + s * k[2]))
        d1 = ts1 - t1
        d2 = ts2 - t2
        A = jnp.stack([
            jnp.stack([s * d1, s * d2], axis=-1),
            jnp.stack([s * s * d1, s * s * d2], axis=-1),
            jnp.stack([s ** 3 * d1, s ** 3 * d2], axis=-1),
            jnp.stack([zeros, zeros], axis=-1),
            jnp.stack([zeros, zeros], axis=-1),
        ], axis=-2)
        b1 = (t1 - ts1) - num * g1
        b2 = (t2 - ts2) - num * g2
    T = jnp.stack([b1, b2], axis=-1)
    m = jnp.einsum("pfai,pfbi,pf->fab", A, A, vis, precision=HIGHEST)
    rhs = jnp.einsum("pfai,pfi,pf->fa", A, T, vis, precision=HIGHEST)
    return jnp.concatenate([m.reshape(-1, 25), rhs], axis=-1)  # (F, 30)


def _solve_full_opencv_round(terms: jax.Array, dist: jax.Array,
                             round_: str, shared: bool) -> jax.Array:
    """One alternation round's solve from the accumulated (F, 30) terms
    -> updated (F, 8) distortion (degenerate cameras keep their current
    values)."""
    nf = terms.shape[0]
    if shared:
        terms = jnp.broadcast_to(
            jnp.sum(terms, axis=0, keepdims=True), (nf, 30)
        )
    n_unk = 5 if round_ == "num" else 3
    m = terms[:, :25].reshape(nf, 5, 5)[:, :n_unk, :n_unk]
    rhs = terms[:, 25: 25 + n_unk]
    tiny = jnp.asarray(np.finfo(np.dtype(terms.dtype)).tiny, terms.dtype)
    tr = jnp.trace(m, axis1=-2, axis2=-1)
    safe = tr > tiny
    m_s = jnp.where(
        safe[:, None, None], m, jnp.eye(n_unk, dtype=m.dtype)[None]
    )
    sol = jnp.linalg.solve(m_s, rhs[..., None])[..., 0]
    ok = safe & jnp.isfinite(sol).all(axis=-1)
    if round_ == "num":
        cur = jnp.concatenate([dist[:, 0:3], dist[:, 6:8]], axis=-1)
        new = jnp.where(ok[:, None], sol, cur)
        return jnp.concatenate(
            [new[:, 0:3], dist[:, 3:6], new[:, 3:5]], axis=-1
        )
    new = jnp.where(ok[:, None], sol, dist[:, 3:6])
    return jnp.concatenate([dist[:, 0:3], new, dist[:, 6:8]], axis=-1)


def distort_points(
    x: jax.Array, f: jax.Array, u: jax.Array | None = None,
    f0: float = 1.0, distortion: jax.Array | None = None,
    distortion_model: str | None = "auto",
) -> jax.Array:
    """Apply a camera's distortion model to pinhole image points:
    (P, F, 2) f0-normalized observations -> their distorted positions
    under ``distortion`` (any supported family). The forward half of
    :func:`undistort_points`."""
    if distortion is None:
        return x
    nf = f.shape[0]
    dt = x.dtype
    u = jnp.zeros((nf, 2), dt) if u is None else jnp.asarray(u, dt)
    model = resolve_distortion_model(distortion, distortion_model)
    g1 = x[..., 0] - (u[:, 0] / f0)[None]
    g2 = x[..., 1] - (u[:, 1] / f0)[None]
    s1, s2, _ = _distortion_shift_and_jacobian(
        f, u, f0, distortion, model, g1, g2
    )
    return x + jnp.stack([s1, s2], axis=-1)


def _distortion_shift_and_jacobian(f, u, f0, dist, model, g1, g2):
    """(shift1, shift2, D) of the distortion at g: the distorted
    prediction is g + shift (+ u/f0) and D is its exact 2x2 Jacobian
    wrt g — obtained from the shared chain by feeding identity basis
    rows (so every model, including the asymmetric thin_prism chain,
    is covered by one code path)."""
    dt = g1.dtype
    nf = f.shape[0]
    st = BAState(
        X=jnp.zeros((0, 3), dt), f=jnp.asarray(f, dt), u=u,
        t=jnp.zeros((nf, 3), dt),
        R=jnp.broadcast_to(jnp.eye(3, dtype=dt), (nf, 3, 3)),
    )
    p = g1 + (u[:, 0] / f0)[None]
    q = g2 + (u[:, 1] / f0)[None]
    r = jnp.ones_like(g1)
    shape = g1.shape
    e1 = jnp.broadcast_to(jnp.asarray([1.0, 0.0], dt), shape + (2,))
    e2 = jnp.broadcast_to(jnp.asarray([0.0, 1.0], dt), shape + (2,))
    dummy9 = jnp.zeros(shape + (9,), dt)
    zero = jnp.zeros_like(g1)
    s1, s2, row1, row2, _, _ = _apply_distortion_chain(
        st, p, q, r, f0, dist, zero, zero, e1, e2, dummy9, dummy9, model
    )
    d = (row1[..., 0], row1[..., 1], row2[..., 0], row2[..., 1])
    return s1, s2, d


def undistort_points(
    x: jax.Array, f: jax.Array, u: jax.Array | None = None,
    f0: float = 1.0, distortion: jax.Array | None = None,
    distortion_model: str | None = "auto", iters: int = 10,
) -> jax.Array:
    """Map observed (distorted) image points to their pinhole-equivalent
    positions — the Newton inverse of the distortion chain (the
    COLMAP-``image_undistorter`` / cv::undistortPoints capability, for
    every supported family including fisheye, rational, FOV, and
    thin-prism).

    x: (P, F, 2) f0-normalized observations; f (F,), u (F, 2) the
    cameras' focal lengths / principal points. Each point solves
    distort(g) = g_obs by damped-free Newton on the exact 2x2 chain
    Jacobian (quadratic convergence from the g_obs init for any
    physically sane distortion; ``iters`` bounds the fixed iteration
    count so the whole map stays one fused jittable expression).
    Round-trip distort(undistort(x)) == x is pinned to fp tolerance by
    the tests."""
    if distortion is None:
        return x
    nf = f.shape[0]
    dt = x.dtype
    u = jnp.zeros((nf, 2), dt) if u is None else jnp.asarray(u, dt)
    model = resolve_distortion_model(distortion, distortion_model)
    t1 = x[..., 0] - (u[:, 0] / f0)[None]  # observed distorted g
    t2 = x[..., 1] - (u[:, 1] / f0)[None]

    def body(_, g):
        g1, g2 = g
        s1, s2, (d11, d12, d21, d22) = _distortion_shift_and_jacobian(
            f, u, f0, distortion, model, g1, g2
        )
        r1 = g1 + s1 - t1  # residual of distort(g) = t
        r2 = g2 + s2 - t2
        det = d11 * d22 - d12 * d21
        det = jnp.where(jnp.abs(det) > 1e-30, det, 1.0)
        g1 = g1 - (d22 * r1 - d12 * r2) / det
        g2 = g2 - (d11 * r2 - d21 * r1) / det
        return g1, g2

    g1, g2 = jax.lax.fori_loop(0, iters, body, (t1, t2))
    return jnp.stack(
        [g1 + (u[:, 0] / f0)[None], g2 + (u[:, 1] / f0)[None]], axis=-1
    )


def lm_step(
    x: jax.Array,
    state: BAState,
    vis: jax.Array,
    free: jax.Array,
    f0: float,
    c: jax.Array,
    axis_name: str | None = None,
    dist: jax.Array | None = None,
    distortion_model: str = "auto",
) -> tuple[BAState, jax.Array, jax.Array]:
    """One damped Gauss-Newton/LM step: derivatives -> Schur solve ->
    update -> new error. The framework's "train step" building block
    (used by the compile-check entry point and custom loops).

    Returns (new_state, error_before, error_after).
    """
    model = resolve_distortion_model(dist, distortion_model)
    derivs, e0 = _compute_derivs(state, x, vis, free, f0, axis_name, dist, model)
    delta_xi, delta_x = _damped_solve(derivs, c, free, axis_name)
    new = _apply_update(state, delta_xi, delta_x)
    e1 = _state_error(new, x, vis, f0, axis_name, dist, model)
    return new, e0, e1


def lm_optimize(
    x: jax.Array,
    state0: BAState,
    vis: jax.Array,
    free: jax.Array,
    f0: float,
    config: LMConfig,
    axis_name: str | None = None,
    init_c: jax.Array | None = None,
    solver=None,
    dist: jax.Array | None = None,
    init_nu: jax.Array | None = None,
) -> tuple[BAState, jax.Array, jax.Array, jax.Array, jax.Array, dict | None]:
    """Levenberg–Marquardt outer loop (reference ``optimize``, ``:77-195``).

    Protocol parity: damping starts at ``init_damping`` (``:100``); the
    inner retry multiplies c by ``scale_factor`` and re-solves *without*
    recomputing derivatives (``:118-167``); an accepted step divides c
    (``:195``); stop when |E' - E| <= delta_tol or max_iter (``:186-191``).

    ``init_c``/``init_nu`` override the starting damping state
    (checkpoint/resume support: pass the values returned by a previous
    segment to continue exactly; ``init_nu`` matters only under
    ``damping="nielsen"``).

    ``solver`` overrides the damped-system solver (signature and return of
    ``_damped_solve``) — the hook the cameras-axis-sharded CG solve plugs
    into (``parallel/sharded_ba_2d.py``).

    Returns (final state, final error, final damping c, final nu,
    n_iters, log): ``log`` always holds ``n_solver_retries`` (damped
    solves over all iterations) and, with ``config.record_log``, the
    per-iteration state trajectory.
    """
    solve = _damped_solve if solver is None else solver
    record = config.record_log
    max_iter = config.max_iter

    model = resolve_distortion_model(dist, config.distortion_model)
    e0 = _state_error(state0, x, vis, f0, axis_name, dist, model)

    if record:
        npts, nf = state0.X.shape[0], state0.f.shape[0]
        log0 = {
            "points": jnp.zeros((max_iter + 1, npts, 3), x.dtype).at[0].set(state0.X),
            "basis": jnp.zeros((max_iter + 1, nf, 3, 3), x.dtype).at[0].set(state0.R),
            "pos": jnp.zeros((max_iter + 1, nf, 3), x.dtype).at[0].set(state0.t),
            "reprojection_error": jnp.zeros((max_iter + 1,), x.dtype).at[0].set(e0),
        }
    else:
        log0 = {}

    nielsen = config.damping == "nielsen"

    def inner(state_c, derivs, e_prev, c, nu, vis_it):
        """Damping retry loop (reference ``:118-167``), bounded. Re-damps
        and re-solves from the same derivative tensors until the trial
        error stops exceeding the current error. In "nielsen" mode the
        post-accept damping comes from the gain ratio instead of a fixed
        divisor."""

        def cond(carry):
            _, _, _, accepted, tries, _ = carry
            return (~accepted) & (tries < config.max_inner_retries)

        def body(carry):
            c_cur, nu_cur, _, _, tries, _ = carry
            delta_xi, delta_x = solve(derivs, c_cur, free, axis_name)
            trial = _apply_update(state_c, delta_xi, delta_x)
            e_trial = _state_error(trial, x, vis_it, f0, axis_name, dist, model)
            accepted = e_trial <= e_prev
            if nielsen:
                pred = _predicted_reduction(derivs, delta_xi, delta_x, c_cur, axis_name)
                rho = (e_prev - e_trial) / jnp.maximum(pred, 1e-30)
                shrink = jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
                c_next = jnp.where(accepted, c_cur * shrink, c_cur * nu_cur)
                # never-accepting storms grow c super-exponentially
                # (c *= nu, nu *= 2): unclamped it hits f32 Inf after
                # ~17 rejections, and Inf/NaN-damped systems poison every
                # later solve. 1e25 already dominates any Hessian scale;
                # 1e12 keeps c * nu finite in f32.
                c_next = jnp.minimum(c_next, jnp.asarray(1e25, c_next.dtype))
                nu_next = jnp.where(accepted, jnp.full_like(nu_cur, 2.0),
                                    jnp.minimum(nu_cur * 2.0,
                                                jnp.asarray(1e12, nu_cur.dtype)))
            else:
                c_next = jnp.where(accepted, c_cur, c_cur * config.scale_factor)
                nu_next = nu_cur
            return c_next, nu_next, e_trial, accepted, tries + 1, trial

        dummy = jax.tree.map(jnp.zeros_like, state_c)
        c_out, nu_out, e_new, accepted, tries, trial = jax.lax.while_loop(
            cond, body,
            (c, nu, jnp.asarray(jnp.inf, x.dtype), jnp.asarray(False), 0, dummy),
        )
        # If no damping level was ever accepted (divergence/NaN: the
        # reference would spin forever in its unbounded retry loop,
        # bundle_adjustment.py:118-167), keep the previous state and error
        # so the outer loop terminates gracefully (delta = 0).
        keep = lambda new, old: jax.tree.map(
            lambda a, b: jnp.where(accepted, a, b), new, old
        )
        trial = keep(trial, state_c)
        e_new = jnp.where(accepted, e_new, e_prev)
        return c_out, nu_out, e_new, trial, tries

    def cond(carry):
        _, _, _, _, count, done, _, _ = carry
        return (~done) & (count < max_iter)

    robust_cfg = resolve_robust(config.robust)
    robust = robust_cfg is not None
    robust_kind = robust_cfg or "huber"

    def body(carry):
        state_c, e_prev, c, nu, count, _, log, retries = carry
        if robust:
            # IRLS: reweight from the current residuals; the accept test
            # and the stopping delta both use this iteration's weights.
            vis_it = _huber_weights(state_c, x, vis, f0, config.huber_delta,
                                    dist, model, robust_kind)
        else:
            vis_it = vis
        derivs, e_prev_w = _compute_derivs(state_c, x, vis_it, free, f0, axis_name, dist, model)
        e_base = e_prev_w if robust else e_prev
        c_new, nu_new, e_new, trial, tries = inner(state_c, derivs, e_base, c, nu, vis_it)
        delta = jnp.abs(e_new - e_base)
        done = delta <= config.delta_tol
        if record:
            log = {
                "points": log["points"].at[count + 1].set(trial.X),
                "basis": log["basis"].at[count + 1].set(trial.R),
                "pos": log["pos"].at[count + 1].set(trial.t),
                "reprojection_error": log["reprojection_error"].at[count + 1].set(e_new),
            }
        # Accepted step divides the damping (reference ``:195``); in
        # nielsen mode the gain-ratio shrink already happened in inner().
        c_out = c_new if nielsen else c_new / config.divisor
        return trial, e_new, c_out, nu_new, count + 1, done, log, retries + tries

    c0 = jnp.asarray(config.init_damping, x.dtype) if init_c is None else init_c
    nu0 = jnp.asarray(2.0, x.dtype) if init_nu is None else init_nu
    (final_state, e_final, c_final, nu_final, n_iter, _, log,
     retries) = jax.lax.while_loop(
        cond, body,
        (state0, e0, c0, nu0, jnp.asarray(0), jnp.asarray(False), log0,
         jnp.asarray(0)),
    )
    return (final_state, e_final, c_final, nu_final, n_iter,
            {**log, "n_solver_retries": retries})


@partial(jax.jit, static_argnames=("f0", "axis", "config"))
def bundle_adjust(
    x: jax.Array,
    init_X: jax.Array,
    init_K: jax.Array,
    init_R: jax.Array,
    init_t: jax.Array,
    f0: float = 1.0,
    visibility: jax.Array | None = None,
    axis: str = "x-right_z-forward",
    config: LMConfig = LMConfig(),
    distortion: jax.Array | None = None,
    init_c: jax.Array | None = None,
    init_nu: jax.Array | None = None,
) -> BAResult:
    """Full bundle adjustment: gauge-normalize, LM-optimize, restore
    (reference ``BundleAdjuster.__init__`` + ``optimize``).

    ``init_c``/``init_nu`` resume the damping schedule (the returned
    ``log`` always carries the final ``c``/``nu``), so segmented runs
    continue exactly — the same contract as the chunked core.

    x: (P, F, 2) observations; init_K/R/t: (F, ...) camera init;
    visibility: optional (P, F) mask (reference ``:56-59``).

    distortion: optional (F, 2) radial (k1, k2) in the BAL camera model
    (``runtime/io.py::load_bal``; /root/reference has no distortion
    model), (F, 4) OPENCV (k1, k2, p1, p2), or (F, 4) OPENCV_FISHEYE
    k1..k4 with ``config.distortion_model="fisheye"``
    (``resolve_distortion_model``). Held fixed unless
    ``config.distortion_rounds > 0``, which
    alternates geometry LM with the exact closed-form per-camera refit
    (``fit_distortion``) — pass ``distortion_rounds > 0`` with
    ``distortion=None`` to start the refit from (0, 0). Distortion is
    similarity-gauge invariant, so it needs no normalize/restore. When a
    log is recorded it covers the final LM segment; ``n_iter`` counts
    all segments.
    """
    dt = x.dtype
    npts, nf, _ = x.shape
    vis = (
        jnp.ones((npts, nf), dtype=dt)
        if visibility is None
        else jnp.asarray(visibility, dtype=dt)
    )

    if visibility is not None:
        # masked observations may hold arbitrary (even non-finite) values;
        # zero them so 0 * nan can never leak through the masked sums
        # (the reference would propagate the NaN, bundle_adjustment.py:674)
        x = jnp.where(vis[..., None] > 0, x, 0.0)
    X0, R0, t0, info = normalize_gauge(init_X, init_R, init_t, axis)
    f_in, u_in = intrinsics_from_K(init_K, f0)
    state0 = BAState(X=X0, f=f_in, u=u_in, t=t0, R=R0)
    free = gauge_mask(nf, axis, dt)

    dist = None if distortion is None else jnp.asarray(distortion, dt)
    model = resolve_distortion_model(dist, config.distortion_model)
    if config.distortion_rounds > 0 and dist is None:
        dist = default_distortion(model, nf, dt)

    n_total = jnp.asarray(0)
    c_seg, nu_seg = init_c, init_nu
    for _ in range(config.distortion_rounds):
        # Refit FIRST: BAL-style problems come with a good geometry init,
        # and running pinhole LM before the first refit walks the free
        # geometry into the distortion-absorbing basin (measured: from a
        # good init, LM-then-refit converges to a wrong (geometry, k)
        # pair with near-identical E; refit-then-LM recovers both).
        # Under the Huber loss the refit uses the IRLS weights — the
        # 2-parameter per-camera LSQ otherwise latches onto the gross
        # outliers the robust geometry pass is busy rejecting.
        if resolve_robust(config.robust) is not None:
            vis_fit = _huber_weights(state0, x, vis, f0, config.huber_delta,
                                     dist, model,
                                     resolve_robust(config.robust))
        else:
            vis_fit = vis
        dist = fit_distortion(state0, x, vis_fit, f0,
                              shared=config.distortion_shared, model=model,
                              dist=dist)
        seg_cfg = dataclasses.replace(config, record_log=False)
        state0, _, c_seg, nu_seg, n_seg, _ = lm_optimize(
            x, state0, vis, free, f0, seg_cfg, init_c=c_seg,
            init_nu=nu_seg, dist=dist
        )
        n_total = n_total + n_seg

    final, e, c_f, nu_f, n_iter, log = lm_optimize(
        x, state0, vis, free, f0, config, init_c=c_seg, init_nu=nu_seg,
        dist=dist
    )

    Xg, Rg, tg = restore_gauge(info, final.X, final.R, final.t)
    return BAResult(
        X=Xg,
        K=build_K(final.f, final.u, f0),
        R=Rg,
        t=tg,
        error=e,
        n_iter=n_iter + n_total,
        log={**(log or {}), "c": c_f, "nu": nu_f},
        distortion=dist,
    )
