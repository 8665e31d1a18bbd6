"""Parameter covariance / uncertainty estimation for bundle adjustment.

The reference (/root/reference) stops at point estimates; production SfM
pipelines (COLMAP/ceres `Covariance`) also report *uncertainties* —
per-point 3x3 and per-camera 9x9 covariance blocks of the BA optimum.
This module computes them on the device from the same Gauss-Newton
blocks the LM cores already generate (``_compute_derivs``), so the cost
is one extra undamped Schur assembly plus one (9F, 9F) Cholesky-backed
inverse — no new derivative code and no LM iterations.

Math. At the optimum the GN Hessian of E = sum w |res|^2 is
H = 2 J^T W J, assembled blockwise as::

    H = [ E   F  ]   E: (P, 3, 3) point blocks      (derivs.matE)
        [ F^T G  ]   F: (P, 3, 9F) coupling         (derivs.matF)
                     G: (F, 9, 9) camera blocks     (derivs.matG)

With i.i.d. observation noise of variance sigma^2 per residual
component (f0-normalized units), Cov(theta) = sigma^2 (J^T W J)^{-1}
= 2 sigma^2 H^{-1}. Blockwise via the camera-side Schur complement
A = G_blockdiag - F^T E^{-1} F (the transpose of the solve the LM cores
do — here the *camera* marginals are wanted, so points are eliminated):

    Sigma_cameras[f] = 2 sigma^2 (A^{-1})[f, f]             (9, 9)
    Sigma_points[i]  = 2 sigma^2 (E_i^{-1}
                       + Y_i A^{-1} Y_i^T),  Y_i = E_i^{-1} F_i  (3, 3)

sigma^2 is estimated from the optimum residuals:
sigma^2 = E / (2 n_obs - n_free) (two residual components per visible
observation; n_free = 3 P + the unpinned camera parameters).

Gauge. BA determines the scene only up to a 7-dof similarity; the cores
pin it by normalizing to camera 0 + unit baseline (``normalize_gauge``)
and masking the pinned parameters (``gauge_mask``). Covariances are
therefore *conditional on that gauge fixing* (pinned entries report
exactly zero) — the standard convention (ceres' covariance is likewise
conditional on its fixed parameter blocks). The returned blocks are
rotated/scaled back to the caller's global frame through the same
similarity restore_gauge applies: points and translations by
scale * R0, rotation perturbations by R0 (the LM update left-multiplies
``rodrigues(d_omega)``, a world-frame perturbation), f and the
principal point untouched.

Robust loss. With ``config.robust`` set the IRLS weights at the
optimum multiply into W — the common practical approximation for
M-estimator covariance (the full sandwich estimator differs by
psi'-factor corrections; the weighted form is what ceres reports).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import HIGHEST, LMConfig, STATE_HIGHEST
from ..ops.linalg import inv3x3
from .bundle_adjustment import (
    BAState,
    _compute_derivs,
    _huber_weights,
    gauge_mask,
    intrinsics_from_K,
    normalize_gauge,
    resolve_distortion_model,
    resolve_robust,
)
from .bundle_adjustment_chunked import _chunk_blocks, _chunked


class BACovariance(NamedTuple):
    point_cov: jax.Array  # (P, 3, 3), global frame
    camera_cov: jax.Array  # (F, 9, 9), (f, u0, v0, t, omega) order
    sigma2: jax.Array  # estimated per-component observation variance
    n_obs: jax.Array  # number of visible observations
    error: jax.Array  # E at the given state (weighted under Huber)


def _schur_inverse(matE, matF, matG, free):
    """(einv, y, a_inv_masked): the camera-marginal machinery shared by
    the dense and chunked paths. ``a_inv_masked`` is A^{-1} with the
    gauge-pinned rows/columns zeroed (their identity placeholders would
    otherwise read as unit variances)."""
    nf9 = matF.shape[-1]
    einv = inv3x3(matE)
    y = jnp.einsum("pxy,pym->pxm", einv, matF, precision=HIGHEST)
    schur = jnp.einsum(
        "pxm,pxn->mn", matF, y, precision=HIGHEST
    )
    return einv, y, _finish_schur_inverse(schur, matG, free, nf9)


def _finish_schur_inverse(schur, matG, free, nf9):
    nf = nf9 // 9
    a = -schur
    a = a.reshape(nf, 9, nf, 9)
    idx = jnp.arange(nf)
    a = a.at[idx, :, idx, :].add(matG)
    a = a.reshape(nf9, nf9)
    a = a * (free[:, None] * free[None, :]) + jnp.diag(1.0 - free)
    cho = jax.scipy.linalg.cho_factor(a)
    a_inv = jax.scipy.linalg.cho_solve(cho, jnp.eye(nf9, dtype=a.dtype))
    return a_inv * (free[:, None] * free[None, :])


def _point_cov_from(einv, y, a_inv, scale2):
    lift = jnp.einsum(
        "pxm,mn,pyn->pxy", y, a_inv, y, precision=HIGHEST
    )
    return scale2 * (einv + lift)


def _camera_cov_from(a_inv, nf, scale2):
    blocks = a_inv.reshape(nf, 9, nf, 9)
    idx = jnp.arange(nf)
    return scale2 * blocks[idx, :, idx, :]


def _global_frame_transforms(info, dt):
    """(M_point (3,3), T_cam (9,9)) mapping normalized-frame covariances
    to the caller's global frame (see module docstring)."""
    r0 = info["R0"].astype(dt)
    scale = info["scale"].astype(dt)
    m_point = scale * r0
    t_cam = jnp.zeros((9, 9), dt)
    t_cam = t_cam.at[0, 0].set(1.0)
    t_cam = t_cam.at[1:3, 1:3].set(jnp.eye(2, dtype=dt))
    t_cam = t_cam.at[3:6, 3:6].set(m_point)
    t_cam = t_cam.at[6:9, 6:9].set(r0)
    return m_point, t_cam


def _finalize(point_cov_n, cam_cov_n, info, sigma2, n_obs, e):
    dt = point_cov_n.dtype
    m_point, t_cam = _global_frame_transforms(info, dt)
    point_cov = jnp.einsum(
        "ij,pjk,lk->pil", m_point, point_cov_n, m_point,
        precision=STATE_HIGHEST,
    )
    cam_cov = jnp.einsum(
        "ij,fjk,lk->fil", t_cam, cam_cov_n, t_cam, precision=STATE_HIGHEST
    )
    return BACovariance(
        point_cov=point_cov, camera_cov=cam_cov, sigma2=sigma2,
        n_obs=n_obs, error=e,
    )


def ba_covariance(
    x: jax.Array,
    X: jax.Array,
    K: jax.Array,
    R: jax.Array,
    t: jax.Array,
    f0: float = 1.0,
    visibility: jax.Array | None = None,
    axis: str = "x-right_z-forward",
    config: LMConfig = LMConfig(),
    distortion: jax.Array | None = None,
) -> BACovariance:
    """Covariance blocks of a converged BA solution (see module
    docstring). Inputs mirror ``bundle_adjust`` — pass the *result*
    state (``BAResult.X/K/R/t`` and its distortion); the same gauge
    convention (``axis``) must be used so the conditioning matches the
    optimization that produced the state."""
    dt = x.dtype
    npts, nf, _ = x.shape
    vis = (
        jnp.ones((npts, nf), dtype=dt)
        if visibility is None
        else jnp.asarray(visibility, dtype=dt)
    )
    if visibility is not None:
        x = jnp.where(vis[..., None] > 0, x, 0.0)
    X0, R0, t0, info = normalize_gauge(X, R, t, axis)
    f_in, u_in = intrinsics_from_K(K, f0)
    state = BAState(X=X0, f=f_in, u=u_in, t=t0, R=R0)
    free = gauge_mask(nf, axis, dt)
    dist = None if distortion is None else jnp.asarray(distortion, dt)
    model = resolve_distortion_model(dist, config.distortion_model)

    if resolve_robust(config.robust) is not None:
        vis_w = _huber_weights(state, x, vis, f0, config.huber_delta,
                               dist, model, resolve_robust(config.robust))
    else:
        vis_w = vis
    derivs, e = _compute_derivs(state, x, vis_w, free, f0, None, dist, model)

    n_obs = jnp.sum(vis > 0)
    n_free = 3.0 * npts + jnp.sum(free)
    dof = jnp.maximum(2.0 * n_obs.astype(dt) - n_free, 1.0)
    sigma2 = e / dof
    scale2 = 2.0 * sigma2

    einv, y, a_inv = _schur_inverse(derivs.matE, derivs.matF, derivs.matG,
                                    free)
    point_cov_n = _point_cov_from(einv, y, a_inv, scale2)
    cam_cov_n = _camera_cov_from(a_inv, nf, scale2)
    return _finalize(point_cov_n, cam_cov_n, info, sigma2, n_obs, e)


def ba_covariance_chunked(
    x: jax.Array,
    X: jax.Array,
    K: jax.Array,
    R: jax.Array,
    t: jax.Array,
    f0: float = 1.0,
    visibility: jax.Array | None = None,
    axis: str = "x-right_z-forward",
    config: LMConfig = LMConfig(),
    distortion: jax.Array | None = None,
    chunk_size: int = 4096,
) -> BACovariance:
    """O(chunk)-memory variant of :func:`ba_covariance` for the 100k+
    point regime: scan 1 accumulates the camera Schur complement over
    point chunks (never materializing the (P, 3, 9F) coupling block),
    scan 2 recomputes each chunk's blocks to form its point covariances
    against the shared A^{-1}. Exactly equals the dense result on the
    same data (parity-pinned)."""
    dt = x.dtype
    npts, nf, _ = x.shape
    vis = (
        jnp.ones((npts, nf), dtype=dt)
        if visibility is None
        else jnp.asarray(visibility, dtype=dt)
    )
    if visibility is not None:
        x = jnp.where(vis[..., None] > 0, x, 0.0)
    X0, R0, t0, info = normalize_gauge(X, R, t, axis)
    free = gauge_mask(nf, axis, dt)
    dist = None if distortion is None else jnp.asarray(distortion, dt)
    model = resolve_distortion_model(dist, config.distortion_model)
    robust_cfg = resolve_robust(config.robust)
    huber_delta = config.huber_delta if robust_cfg is not None else None
    robust_kind = robust_cfg or "huber"

    pad = (-npts) % chunk_size
    if pad:
        x = jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], dt)], axis=0)
        vis = jnp.concatenate(
            [vis, jnp.zeros((pad,) + vis.shape[1:], dt)], axis=0
        )
        X0 = jnp.concatenate(
            [X0, jnp.broadcast_to(jnp.mean(X0, axis=0), (pad, 3))], axis=0
        )
    n_chunks = x.shape[0] // chunk_size
    x_ch = _chunked(x, n_chunks)
    vis_ch = _chunked(vis, n_chunks)
    X_ch = _chunked(X0, n_chunks)
    f_in, u_in = intrinsics_from_K(K, f0)
    cam = BAState(X=jnp.zeros((0, 3), dt), f=f_in, u=u_in, t=t0, R=R0)
    nf9 = 9 * nf

    def body(carry, inp):
        schur_acc, g_acc, e_acc = carry
        X_c, x_c, vis_c = inp
        _, _, matE, matF, matG, e_chunk = _chunk_blocks(
            cam, X_c, x_c, vis_c, free, f0, huber_delta, dist, model,
            robust_kind,
        )
        einv = inv3x3(matE)
        y = jnp.einsum("pxy,pym->pxm", einv, matF, precision=HIGHEST)
        schur_acc = schur_acc + jnp.einsum(
            "pxm,pxn->mn", matF, y, precision=HIGHEST
        )
        return (schur_acc, g_acc + matG, e_acc + e_chunk), None

    (schur, g_sum, e), _ = jax.lax.scan(
        body,
        (jnp.zeros((nf9, nf9), dt), jnp.zeros((nf, 9, 9), dt),
         jnp.zeros((), dt)),
        (X_ch, x_ch, vis_ch),
    )
    a_inv = _finish_schur_inverse(schur, g_sum, free, nf9)

    n_obs = jnp.sum(vis > 0)
    n_free = 3.0 * npts + jnp.sum(free)
    dof = jnp.maximum(2.0 * n_obs.astype(dt) - n_free, 1.0)
    sigma2 = e / dof
    scale2 = 2.0 * sigma2

    def body2(_, inp):
        X_c, x_c, vis_c = inp
        _, _, matE, matF, _, _ = _chunk_blocks(
            cam, X_c, x_c, vis_c, free, f0, huber_delta, dist, model,
            robust_kind,
        )
        einv = inv3x3(matE)
        y = jnp.einsum("pxy,pym->pxm", einv, matF, precision=HIGHEST)
        return None, _point_cov_from(einv, y, a_inv, scale2)

    _, pc_ch = jax.lax.scan(body2, None, (X_ch, x_ch, vis_ch))
    point_cov_n = pc_ch.reshape(-1, 3, 3)[:npts]
    cam_cov_n = _camera_cov_from(a_inv, nf, scale2)
    return _finalize(point_cov_n, cam_cov_n, info, sigma2, n_obs, e)


# ---------------------------------------------------------------------------
# host-streamed variant (observations never fully device-resident)
# ---------------------------------------------------------------------------

from functools import partial as _partial  # noqa: E402


@_partial(jax.jit, static_argnames=("f0", "model", "robust_kind"),
          donate_argnums=(0,))
def _cov_accumulate_chunk(accs, cam, X_c, x_c, vis_c, free, f0: float,
                          dist=None, huber_delta=None,
                          model: str | None = None,
                          robust_kind: str = "huber"):
    """Fold one observation chunk into (schur, G, E) for the covariance
    build (undamped; the streamed analog of the chunked scan 1)."""
    schur_acc, g_acc, e_acc = accs
    _, _, matE, matF, matG, e_chunk = _chunk_blocks(
        cam, X_c, x_c, vis_c, free, f0, huber_delta, dist, model, robust_kind
    )
    einv = inv3x3(matE)
    y = jnp.einsum("pxy,pym->pxm", einv, matF, precision=HIGHEST)
    schur_acc = schur_acc + jnp.einsum(
        "pxm,pxn->mn", matF, y, precision=HIGHEST
    )
    return (schur_acc, g_acc + matG, e_acc + e_chunk)


@_partial(jax.jit, static_argnames=("f0", "model", "robust_kind"))
def _cov_point_chunk(cam, X_c, x_c, vis_c, free, f0: float, a_inv, scale2,
                     dist=None, huber_delta=None, model: str | None = None,
                     robust_kind: str = "huber"):
    """One chunk's point-covariance blocks against the completed
    camera-marginal inverse."""
    _, _, matE, matF, _, _ = _chunk_blocks(
        cam, X_c, x_c, vis_c, free, f0, huber_delta, dist, model, robust_kind
    )
    einv = inv3x3(matE)
    y = jnp.einsum("pxy,pym->pxm", einv, matF, precision=HIGHEST)
    return _point_cov_from(einv, y, a_inv, scale2)


def ba_covariance_streamed(
    x_host,
    X: jax.Array,
    K: jax.Array,
    R: jax.Array,
    t: jax.Array,
    f0: float = 1.0,
    visibility=None,
    axis: str = "x-right_z-forward",
    config: LMConfig = LMConfig(),
    distortion: jax.Array | None = None,
    chunk_size: int = 4096,
    prefetch: int = 2,
    dtype=jnp.float32,
) -> BACovariance:
    """Host-streamed :func:`ba_covariance`: observations (and the mask)
    stay in host memory and stream through the same double-buffered
    chunk feed as ``bundle_adjust_streamed`` — two streaming passes
    (Schur accumulation, then point blocks), O(chunk) observation bytes
    device-resident. Parity-pinned against the dense path."""
    import numpy as np_

    from .bundle_adjustment_streamed import _ChunkFeed

    x_host = np_.asarray(x_host)
    npts, nf, _ = x_host.shape
    X0, R0, t0, info = normalize_gauge(
        jnp.asarray(X, dtype), jnp.asarray(R, dtype),
        jnp.asarray(t, dtype), axis,
    )
    K = jnp.asarray(K, dtype)
    f_in, u_in = intrinsics_from_K(K, f0)
    cam = BAState(X=jnp.zeros((0, 3), dtype), f=f_in, u=u_in, t=t0, R=R0)
    free = gauge_mask(nf, axis, dtype)
    dist = None if distortion is None else jnp.asarray(distortion, dtype)
    model = resolve_distortion_model(dist, config.distortion_model)
    robust_cfg = resolve_robust(config.robust)
    huber_delta = config.huber_delta if robust_cfg is not None else None
    robust_kind = robust_cfg or "huber"
    nf9 = 9 * nf

    feed = _ChunkFeed(
        x_host, visibility, chunk_size,
        np_.dtype(jnp.zeros((), dtype).dtype), prefetch=prefetch,
    )

    def x_chunk(lo, hi):
        if hi - lo == feed.chunk:
            return jax.lax.dynamic_slice_in_dim(X0, lo, feed.chunk)
        return jnp.concatenate(
            [X0[lo:hi], jnp.zeros((feed.chunk - (hi - lo), 3), dtype)]
        )

    accs = (jnp.zeros((nf9, nf9), dtype), jnp.zeros((nf, 9, 9), dtype),
            jnp.zeros((), dtype))
    n_obs = 0
    for lo, hi, x_c, vis_c in feed:
        accs = _cov_accumulate_chunk(
            accs, cam, x_chunk(lo, hi), x_c, vis_c, free, f0, dist,
            huber_delta, model, robust_kind,
        )
        n_obs += int(np_.sum(np_.asarray(vis_c) > 0))
    schur, g_sum, e = accs
    a_inv = _finish_schur_inverse(schur, g_sum, free, nf9)

    n_free = 3.0 * npts + jnp.sum(free)
    dof = max(2.0 * n_obs - float(n_free), 1.0)
    sigma2 = e / dof
    scale2 = 2.0 * sigma2

    parts = []
    for lo, hi, x_c, vis_c in feed:
        pc = _cov_point_chunk(
            cam, x_chunk(lo, hi), x_c, vis_c, free, f0, a_inv, scale2,
            dist, huber_delta, model, robust_kind,
        )
        parts.append(pc[: hi - lo])
    point_cov_n = jnp.concatenate(parts, axis=0)
    cam_cov_n = _camera_cov_from(a_inv, nf, scale2)
    return _finalize(point_cov_n, cam_cov_n, info, sigma2,
                     jnp.asarray(n_obs), e)
