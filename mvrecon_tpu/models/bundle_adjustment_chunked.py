"""Memory-streamed bundle adjustment for the 100k-point regime.

The dense LM core (``bundle_adjustment.py``) materializes (P, F, 9) and
(P, 3, 9F) tensors — perfect up to tens of thousands of points, impossible
at P=100k, F=1000 (the coupling block alone is ~11 GB; the reference's own
Schur reduction materializes a (P, 9F, 9F) float64 intermediate, 63 GB at
P=10k/F=100, which is why it cannot scale at all).

This variant never holds more than one *chunk* of points in HBM:

- per LM retry, a first ``lax.scan`` over point-chunks recomputes the
  chunk's derivative blocks on the fly and accumulates only the reduced
  camera system A (9F, 9F), its rhs b (9F,), and the scalar error — the
  classic blocked Schur accumulation, with the (3C, 9F)^T (3C, 9F) chunk
  product as one matmul;
- after the replicated (9F, 9F) solve, a second scan recomputes each
  chunk's blocks once more to back-substitute its point updates and
  accumulate the trial error under the updated cameras.

Recomputing derivatives per scan trades O(P F) cheap FLOPs for an O(P F)
memory ceiling -> O(C F); the expensive O(P (9F)^2) Schur work happens
exactly once per retry, as in the dense path. Semantics (damping protocol,
stopping rules, gauge) are identical to the dense core and the reference.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..config import HIGHEST, LMConfig
from ..ops.linalg import chol3x3, inv3x3, inv_lower3, solve_lower3
from ..ops.pallas_syrk import (
    finish_syrk_accumulator,
    syrk_accumulator_dim,
    syrk_lower_or_fallback,
)
from .bundle_adjustment import (
    BAResult,
    BAState,
    _DISTORTION_NCOLS,
    default_distortion,
    _apply_distortion_chain,
    _apply_update,
    _camera_param_derivs,
    FULL_OPENCV_ALTERNATIONS,
    _FOV_GN_STEPS,
    _distorted_residual,
    _fov_gn_terms,
    _solve_fov_step,
    robust_weight,
    _distortion_lsq_terms,
    _full_opencv_lsq_terms,
    _psum,
    _solve_distortion_lsq,
    _solve_full_opencv_round,
    build_K,
    calc_pqr,
    distortion_nterms,
    gauge_mask,
    intrinsics_from_K,
    normalize_gauge,
    resolve_distortion_model,
    resolve_robust,
    restore_gauge,
)


def _chunk_factors(state_cam: BAState, X_c, x_c, vis_c, f0, huber_delta=None,
                   dist=None, model: str | None = None,
                   robust_kind: str = "huber"):
    """Rank-2 Jacobian factors for one point chunk: every second-derivative
    block is 2 * vis * (a1 (x) b1 + a2 (x) b2), so downstream stages work
    from (a1, a2 (C, F, 3); b1, b2 (C, F, 9); residuals) without
    materializing the blocks they don't need.

    With ``huber_delta`` set, IRLS Huber weights (computed from this
    chunk's residuals at the current state — identical across the build
    and back-substitution scans of an iteration) multiply into the
    returned effective visibility.

    With ``dist`` (any supported distortion family) the residuals and
    the factors chain through the exact 2x2 distortion Jacobian exactly
    as in the dense core (``_apply_distortion_chain``) —
    per-observation elementwise work, so the O(chunk) memory contract
    is untouched."""
    st = state_cam._replace(X=X_c)
    K = build_K(st.f, st.u, f0)
    pmat, p, q, r = calc_pqr(X_c, K, st.R, st.t)

    dpdX, dqdX, drdX = pmat[:, 0, :3], pmat[:, 1, :3], pmat[:, 2, :3]
    dpdc, dqdc, drdc = _camera_param_derivs(st, p, q, r, f0)

    r = jnp.where(vis_c > 0, r, jnp.ones_like(r))  # 0*inf guard (padding)
    res_p = p / r - x_c[..., 0] / f0
    res_q = q / r - x_c[..., 1] / f0

    inv_r2 = 1.0 / (r * r)
    a1 = (r[..., None] * dpdX[None] - p[..., None] * drdX[None]) * inv_r2[..., None]
    a2 = (r[..., None] * dqdX[None] - q[..., None] * drdX[None]) * inv_r2[..., None]
    b1 = (r[..., None] * dpdc - p[..., None] * drdc) * inv_r2[..., None]
    b2 = (r[..., None] * dqdc - q[..., None] * drdc) * inv_r2[..., None]

    if dist is not None:
        res_p, res_q, a1, a2, b1, b2 = _apply_distortion_chain(
            st, p, q, r, f0, dist, res_p, res_q, a1, a2, b1, b2, model
        )

    if huber_delta is not None:
        # IRLS weights from the model's actual (distorted) residuals
        mag = jnp.sqrt(res_p**2 + res_q**2)
        vis_c = vis_c * robust_weight(mag, huber_delta, robust_kind)

    return a1, a2, b1, b2, res_p, res_q, vis_c


def _point_grad_and_block(a1, a2, res_p, res_q, vis_c):
    """d_P (C, 3) and matE (C, 3, 3) from the factors (with the unseen-
    point identity guard)."""
    visf = vis_c[..., None]
    d_P = 2.0 * jnp.sum(visf * (res_p[..., None] * a1 + res_q[..., None] * a2), axis=1)
    vw = visf[..., None]
    matE = 2.0 * jnp.sum(
        vw * jnp.einsum("pfi,pfj->pfij", a1, a1, precision=HIGHEST)
        + vw * jnp.einsum("pfi,pfj->pfij", a2, a2, precision=HIGHEST),
        axis=1,
    )
    seen = (jnp.sum(vis_c, axis=1) > 0).astype(matE.dtype)
    matE = matE + (1.0 - seen)[:, None, None] * jnp.eye(3, dtype=matE.dtype)
    return d_P, matE


def _chunk_blocks(state_cam: BAState, X_c, x_c, vis_c, free, f0, huber_delta=None,
                  dist=None, model: str | None = None,
                  robust_kind: str = "huber"):
    """Derivative blocks for one point chunk (C points): the chunk-local
    analog of ``_compute_derivs`` (same math, same reference citations)."""
    nf = state_cam.f.shape[0]
    a1, a2, b1, b2, res_p, res_q, vis_c = _chunk_factors(
        state_cam, X_c, x_c, vis_c, f0, huber_delta, dist, model, robust_kind
    )
    e_chunk = jnp.sum(vis_c * (res_p**2 + res_q**2))

    visf = vis_c[..., None]
    d_F = 2.0 * jnp.sum(visf * (res_p[..., None] * b1 + res_q[..., None] * b2), axis=0)
    d_F = d_F.reshape(9 * nf) * free

    d_P, matE = _point_grad_and_block(a1, a2, res_p, res_q, vis_c)

    vw = visf[..., None]
    matG = 2.0 * jnp.sum(
        vw * jnp.einsum("pfi,pfj->pfij", b1, b1, precision=HIGHEST)
        + vw * jnp.einsum("pfi,pfj->pfij", b2, b2, precision=HIGHEST),
        axis=0,
    )
    # Build matF directly in (C, 3i, F, 9j) layout (no transpose copy).
    matF_blocks = 2.0 * (
        vw.transpose(0, 2, 1, 3) * jnp.einsum("pfi,pfj->pifj", a1, b1, precision=HIGHEST)
        + vw.transpose(0, 2, 1, 3) * jnp.einsum("pfi,pfj->pifj", a2, b2, precision=HIGHEST)
    )
    npts_c = X_c.shape[0]
    matF = matF_blocks.reshape(npts_c, 3, 9 * nf)
    # No free-mask multiply here: the assembled system is gauge-projected
    # (identity rows decouple fixed params), delta_xi is masked after the
    # solve, and skipping it saves a full (C, 3, 9F) HBM read+write.

    return d_P, d_F, matE, matF, matG, e_chunk


def _kadd(acc, x):
    """One Kahan compensated-summation step on a (sum, comp) carry pair.

    The LM accept test and the Nielsen gain ratio read scalars that are
    plain f32 sums of per-chunk partials (131 chunks at 100k points);
    compensating them removes the accumulation-order noise from the
    *decisions* at ~zero cost (3 scalar ops per chunk), so the retry
    count no longer depends on the chunk size.
    """
    s, comp = acc
    y = x - comp
    t = s + y
    return (t, (t - s) - y)


def _vary(v, axis_name):
    """Mark a scan-carry init as device-varying over ``axis_name`` (shard_map
    varying-type system: a replicated init cannot carry shard-dependent
    accumulations)."""
    if axis_name is None:
        return v
    return jax.tree.map(
        lambda a: jax.lax.pcast(a, (axis_name,), to="varying"), v
    )


def _build_system(
    state_cam, X_ch, x_ch, vis_ch, free, f0, c, axis_name=None, huber_delta=None,
    dist=None, model: str | None = None, robust_kind: str = "huber",
):
    """Scan 1: accumulate the damped reduced camera system over chunks
    (then over devices when ``axis_name`` is set — sharding composes with
    chunking for the multi-chip million-point regime).

    Returns (A (9F, 9F) with gauge projection, b (9F,), E_now)."""
    nf = state_cam.f.shape[0]
    nf9 = 9 * nf
    dt = x_ch.dtype
    eye3 = jnp.eye(3, dtype=dt)

    def body(carry, inp):
        schur_acc, b_acc, g_acc, df_acc, e_acc = carry
        X_c, x_c, vis_c = inp
        d_P, d_F, matE, matF, matG, e_chunk = _chunk_blocks(
            state_cam, X_c, x_c, vis_c, free, f0, huber_delta, dist, model,
            robust_kind,
        )
        # Cholesky-split the damped point blocks: F^T Einv F = (L^-1 F)^T
        # (L^-1 F) — a *symmetric* rank-k product, lower tiles only on
        # the GPU (ops/pallas_syrk.py).
        matEc = matE + c * matE * eye3[None]
        linv = inv_lower3(chol3x3(matEc))
        # one batched matmul instead of 3-step substitution (layout win)
        y = jnp.einsum("pxy,pym->pxm", linv, matF, precision=HIGHEST)
        yd = jnp.einsum("pxy,py->px", linv, d_P, precision=HIGHEST)  # (C, 3)
        npts_c = X_c.shape[0]
        # Deferred-mirror SYRK: per-chunk partials carry only the (padded)
        # lower tiles; the mirror/unpad happens once after the scan.
        schur_acc = schur_acc + syrk_lower_or_fallback(
            y.reshape(npts_c * 3, nf9), HIGHEST, schur_acc.shape[0]
        )
        b_acc = b_acc + jnp.einsum("pxm,px->m", y, yd, precision=HIGHEST)
        return (
            schur_acc, b_acc, g_acc + matG, df_acc + d_F,
            _kadd(e_acc, e_chunk),
        ), None

    n_acc = syrk_accumulator_dim(nf9, dt)
    init = _vary(
        (
            jnp.zeros((n_acc, n_acc), dt),
            jnp.zeros((nf9,), dt),
            jnp.zeros((nf, 9, 9), dt),
            jnp.zeros((nf9,), dt),
            (jnp.zeros((), dt), jnp.zeros((), dt)),
        ),
        axis_name,
    )
    (schur, b_p, g, d_f, (e_now, _)), _ = jax.lax.scan(body, init, (X_ch, x_ch, vis_ch))
    schur = finish_syrk_accumulator(_psum(schur, axis_name), nf9, dt)
    b_p = _psum(b_p, axis_name)
    g = _psum(g, axis_name)
    d_f = _psum(d_f, axis_name)
    e_now = _psum(e_now, axis_name)

    gc = g + c * g * jnp.eye(9, dtype=dt)[None]
    a = -schur
    a = a.reshape(nf, 9, nf, 9)
    idx = jnp.arange(nf)
    a = a.at[idx, :, idx, :].add(gc)
    a = a.reshape(nf9, nf9)
    a = a * (free[:, None] * free[None, :]) + jnp.diag(1.0 - free)
    b = b_p - d_f
    diag_g = jnp.diagonal(g, axis1=-2, axis2=-1).reshape(-1)  # (9F,) undamped
    return a, b, e_now, (diag_g, d_f)


def _backsub_and_trial(
    state_cam, trial_cam, X_ch, x_ch, vis_ch, free, f0, c, delta_xi,
    axis_name=None, huber_delta=None, dist=None,
    model: str | None = None, robust_kind: str = "huber",
):
    """Scan 2: per chunk, recompute blocks at the *current* state, back-
    substitute the point update, and accumulate the trial error under the
    *updated* cameras. Returns (X_new chunks, E_trial)."""
    dt = x_ch.dtype
    eye3 = jnp.eye(3, dtype=dt)
    K_trial = build_K(trial_cam.f, trial_cam.u, f0)

    nf = state_cam.f.shape[0]
    dxi = (delta_xi * free).reshape(nf, 9)

    def body(acc, inp):
        e_acc, dDd_acc, gd_acc = acc
        X_c, x_c, vis_c = inp
        # F @ delta_xi factors through the rank-2 block structure:
        #   (F dxi)[p, x] = 2 sum_f vis (a1[p,f,x] <b1[p,f], dxi_f>
        #                             + a2[p,f,x] <b2[p,f], dxi_f>)
        # so the (C, 3, 9F) coupling block is never materialized here.
        a1, a2, b1, b2, res_p, res_q, vis_c = _chunk_factors(
            state_cam, X_c, x_c, vis_c, f0, huber_delta, dist, model,
            robust_kind,
        )
        d_P, matE = _point_grad_and_block(a1, a2, res_p, res_q, vis_c)
        matEc = matE + c * matE * eye3[None]
        einv = inv3x3(matEc)
        s1 = vis_c * jnp.einsum("pfi,fi->pf", b1, dxi, precision=HIGHEST)
        s2 = vis_c * jnp.einsum("pfi,fi->pf", b2, dxi, precision=HIGHEST)
        f_dxi = 2.0 * (
            jnp.einsum("pf,pfx->px", s1, a1, precision=HIGHEST)
            + jnp.einsum("pf,pfx->px", s2, a2, precision=HIGHEST)
        )
        rhs = f_dxi + d_P
        delta_x = -jnp.einsum("pxy,py->px", einv, rhs, precision=HIGHEST)
        X_new = X_c + delta_x

        # point-side terms of the gain-ratio's predicted reduction
        diag_e = jnp.diagonal(matE, axis1=-2, axis2=-1)
        dDd_c = jnp.sum(delta_x * diag_e * delta_x)
        gd_c = jnp.sum(d_P * delta_x)

        _, p, q, r = calc_pqr(X_new, K_trial, trial_cam.R, trial_cam.t)
        r = jnp.where(vis_c > 0, r, jnp.ones_like(r))
        res_tp, res_tq = _distorted_residual(
            trial_cam, p, q, r, x_c, f0, dist, model
        )
        e_c = jnp.sum(vis_c * (res_tp**2 + res_tq**2))
        return (
            _kadd(e_acc, e_c), _kadd(dDd_acc, dDd_c), _kadd(gd_acc, gd_c)
        ), X_new

    zero = _vary(jnp.zeros((), dt), axis_name)
    zp = (zero, zero)
    ((e_trial, _), (dDd_pts, _), (gd_pts, _)), X_new_ch = jax.lax.scan(
        body, (zp, zp, zp), (X_ch, x_ch, vis_ch)
    )
    return (
        X_new_ch,
        _psum(e_trial, axis_name),
        _psum(dDd_pts, axis_name),
        _psum(gd_pts, axis_name),
    )


def _chunked(arr: jax.Array, n_chunks: int) -> jax.Array:
    return arr.reshape((n_chunks, arr.shape[0] // n_chunks) + arr.shape[1:])


def chunk_points(x: jax.Array, vis: jax.Array, X: jax.Array, chunk_size: int):
    """Pad the points axis of (x (P, F, 2), vis (P, F) or (P, 1),
    X (P, 3)) to a multiple of ``chunk_size`` and split it into
    (n_chunks, chunk_size, ...) blocks. Padded points are unseen
    (vis = 0) and sit at mean(X), so they contribute nothing."""
    pad = (-x.shape[0]) % chunk_size
    if pad:
        dt = x.dtype
        x = jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], dt)], axis=0)
        vis = jnp.concatenate([vis, jnp.zeros((pad,) + vis.shape[1:], dt)], axis=0)
        X = jnp.concatenate(
            [X, jnp.broadcast_to(jnp.mean(X, axis=0), (pad, 3))], axis=0
        )
    n_chunks = x.shape[0] // chunk_size
    return _chunked(x, n_chunks), _chunked(vis, n_chunks), _chunked(X, n_chunks)


def lm_optimize_chunked(
    x: jax.Array,
    state0: BAState,
    vis: jax.Array,
    free: jax.Array,
    f0: float,
    config: LMConfig,
    chunk_size: int,
    axis_name: str | None = None,
    init_c: jax.Array | None = None,
    init_nu: jax.Array | None = None,
    dist: jax.Array | None = None,
) -> tuple[BAState, jax.Array, jax.Array, jax.Array, jax.Array, jax.Array]:
    """Chunk-streamed LM with the dense core's exact protocol
    (reference ``bundle_adjustment.py:77-195``). Returns
    (state, error, c, nu, n_iter, total_solver_retries). With ``axis_name``
    set (inside shard_map over points) camera-side accumulators psum across
    devices; everything point-local stays local.

    ``init_c``/``init_nu`` resume the damping schedule: running k then m
    iterations with the carried (state, c, nu) equals one k+m-iteration
    run — the checkpoint/resume contract for the long 100k+-point runs.

    With ``config.record_log`` the last return value is a *scalar* log —
    ``{"reprojection_error": (max_iter + 1,)}`` — O(max_iter) memory at
    any problem size. The dense core's full-state animation log would be
    (max_iter, P, 3)-class tensors, which is exactly what this core
    exists to avoid; callers wanting state trajectories at chunked scale
    should checkpoint segments instead (``runtime/elastic.py``)."""
    npts = x.shape[0]
    dt = x.dtype
    model = resolve_distortion_model(dist, config.distortion_model)
    x_ch, vis_ch, X_ch0 = chunk_points(x, vis, state0.X, chunk_size)
    cam0 = state0._replace(X=jnp.zeros((0, 3), dt))

    def error_of(cam, X_ch_):
        K = build_K(cam.f, cam.u, f0)

        def body(acc, inp):
            X_c, x_c, vis_c = inp
            _, p, q, r = calc_pqr(X_c, K, cam.R, cam.t)
            r = jnp.where(vis_c > 0, r, jnp.ones_like(r))
            res_p, res_q = _distorted_residual(cam, p, q, r, x_c, f0, dist,
                                               model)
            e = jnp.sum(vis_c * (res_p**2 + res_q**2))
            return acc + e, None

        e, _ = jax.lax.scan(
            body, _vary(jnp.zeros((), dt), axis_name), (X_ch_, x_ch, vis_ch)
        )
        return _psum(e, axis_name)

    e0 = error_of(cam0, X_ch0)

    record = config.record_log
    log0 = (
        {"reprojection_error": jnp.zeros((config.max_iter + 1,), dt).at[0].set(e0)}
        if record else {}
    )

    nielsen = config.damping == "nielsen"
    robust_cfg = resolve_robust(config.robust)
    huber_delta = config.huber_delta if robust_cfg is not None else None
    robust_kind = robust_cfg or "huber"


    def inner(cam, X_ch_, e_prev, c, nu):
        def cond(carry):
            _, _, _, _, _, _, accepted, tries = carry
            return (~accepted) & (tries < config.max_inner_retries)

        def solve_cam(a, b):
            """Damped camera solve; with ``config.jacobi_scaling`` the
            system is symmetrically diag-scaled first (identity rows keep
            diag == 1, so padding/fixed coords are untouched)."""
            if config.jacobi_scaling:
                s = jax.lax.rsqrt(jnp.diagonal(a))
                a = a * (s[:, None] * s[None, :])
                b = b * s
            sol = jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(a), b)
            return sol * s if config.jacobi_scaling else sol

        def body(carry):
            c_cur, nu_cur, _, _, _, _, _, tries = carry
            a, b, e_w, (diag_g, d_f) = _build_system(
                cam, X_ch_, x_ch, vis_ch, free, f0, c_cur, axis_name,
                huber_delta, dist, model, robust_kind,
            )
            delta_xi = solve_cam(a, b) * free
            trial_cam = _apply_update(cam, delta_xi, jnp.zeros((0, 3), dt))
            X_new_ch, e_trial, dDd_pts, gd_pts = _backsub_and_trial(
                cam, trial_cam, X_ch_, x_ch, vis_ch, free, f0, c_cur, delta_xi,
                axis_name, huber_delta, dist=dist, model=model,
                robust_kind=robust_kind,
            )
            e_base = e_w if huber_delta is not None else e_prev
            accepted = e_trial <= e_base
            if nielsen:
                dDd = dDd_pts + jnp.sum(delta_xi * diag_g * delta_xi)
                g_d = gd_pts + jnp.sum(d_f * delta_xi)
                pred = 0.5 * (c_cur * dDd - g_d)
                rho = (e_base - e_trial) / jnp.maximum(pred, 1e-30)
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
            return (c_next, nu_next, e_trial, e_base, trial_cam, X_new_ch,
                    accepted, tries + 1)

        dummy_cam = jax.tree.map(jnp.zeros_like, cam)
        (c_out, nu_out, e_new, e_base_out, trial_cam, X_new_ch, accepted,
         tries) = jax.lax.while_loop(
            cond,
            body,
            (c, nu, jnp.asarray(jnp.inf, dt), e_prev, dummy_cam,
             jnp.zeros_like(X_ch_), jnp.asarray(False), 0),
        )
        # Never-accepted (divergence/NaN): keep previous state; outer loop
        # then stops with delta = 0 (see dense core for rationale).
        trial_cam = jax.tree.map(
            lambda a, b: jnp.where(accepted, a, b), trial_cam, cam
        )
        X_new_ch = jnp.where(accepted, X_new_ch, X_ch_)
        e_new = jnp.where(accepted, e_new, e_base_out)
        return c_out, nu_out, e_new, e_base_out, trial_cam, X_new_ch, tries

    def cond(carry):
        _, _, _, _, _, count, done, _, _ = carry
        return (~done) & (count < config.max_iter)

    def body(carry):
        cam, X_ch_, e_prev, c, nu, count, _, retries, log = carry
        c_new, nu_new, e_new, e_base, cam_new, X_ch_new, tries = inner(
            cam, X_ch_, e_prev, c, nu
        )
        done = jnp.abs(e_new - e_base) <= config.delta_tol
        c_out = c_new if nielsen else c_new / config.divisor
        if record:
            log = {"reprojection_error":
                   log["reprojection_error"].at[count + 1].set(e_new)}
        return (cam_new, X_ch_new, e_new, c_out, nu_new, count + 1,
                done, retries + tries, log)

    c0 = jnp.asarray(config.init_damping, dt) if init_c is None else jnp.asarray(init_c, dt)
    nu0 = jnp.asarray(2.0, dt) if init_nu is None else jnp.asarray(init_nu, dt)
    (cam_f, X_ch_f, e_f, c_f, nu_f, n_iter, _, n_retries,
     log_f) = jax.lax.while_loop(
        cond, body,
        (cam0, X_ch0, e0, c0, nu0, jnp.asarray(0), jnp.asarray(False),
         jnp.asarray(0), log0),
    )
    X_full = X_ch_f.reshape(-1, 3)[:npts]
    return (cam_f._replace(X=X_full), e_f, c_f, nu_f, n_iter, n_retries,
            log_f if record else None)


def fit_distortion_chunked(
    state: BAState, x: jax.Array, vis: jax.Array, f0: float,
    chunk_size: int, shared: bool = False,
    huber_delta: float | None = None, dist=None,
    axis_name: str | None = None, tangential: bool | None = None,
    model: str | None = None, robust_kind: str = "huber",
) -> jax.Array:
    """Chunk-streamed closed-form radial-distortion refit: the (F, 5)
    normal-equation terms of the linear-in-(k1, k2) fit are per-point
    sums (``_distortion_lsq_terms``), so a ``lax.scan`` over point chunks
    accumulates them under the same O(chunk) HBM contract as the LM
    core. Exactly equals the dense ``fit_distortion`` on the same data.

    With ``huber_delta`` the fit is IRLS-weighted by the *current*
    model's (``dist``) distorted residuals, computed per chunk — no
    dense (P, F) weight array is ever materialized.

    ``tangential``/``model`` select the 4-parameter fits ((F, 20)
    normal terms); by default the model follows the current ``dist``'s
    column count (``resolve_distortion_model``)."""
    if model is None:
        if tangential is None:
            model = resolve_distortion_model(dist, "auto")
        else:
            model = "opencv" if tangential else "radial"

    dt = x.dtype
    x_ch, vis_ch, X_ch = chunk_points(x, vis, state.X, chunk_size)
    cam = state._replace(X=jnp.zeros((0, 3), dt))
    K = build_K(cam.f, cam.u, f0)
    chunks = (X_ch, x_ch, vis_ch)

    def accumulate(terms_of_chunk):
        def body(acc, inp):
            X_c, x_c, vis_c = inp
            _, p, q, r = calc_pqr(X_c, K, cam.R, cam.t)
            r = jnp.where(vis_c > 0, r, jnp.ones_like(r))
            if huber_delta is not None:
                res_p, res_q = _distorted_residual(
                    cam, p, q, r, x_c, f0, dist, model
                )
                mag = jnp.sqrt(res_p**2 + res_q**2)
                vis_c = vis_c * robust_weight(mag, huber_delta, robust_kind)
            return acc + terms_of_chunk(p, q, r, x_c, vis_c), None

        acc0 = jnp.zeros((cam.f.shape[0], distortion_nterms(model)), dt)
        if axis_name is not None:
            acc0 = _vary(acc0, axis_name)  # shard-varying body output
        terms, _ = jax.lax.scan(body, acc0, chunks)
        return _psum(terms, axis_name)

    if model == "full_opencv":
        # rational model: the same chunked accumulation per alternation
        # round (see _full_opencv_lsq_terms) — 2 scans per alternation
        cur = dist if dist is not None else jnp.zeros((cam.f.shape[0], 8), dt)
        for _ in range(FULL_OPENCV_ALTERNATIONS):
            for round_ in ("num", "den"):
                terms = accumulate(
                    lambda p, q, r, x_c, vis_c, rr=round_, dd=cur:
                    _full_opencv_lsq_terms(cam, p, q, r, x_c, vis_c, f0,
                                           dd, rr)
                )
                cur = _solve_full_opencv_round(terms, cur, round_, shared)
        return cur
    if model == "fov":
        # scalar GN on the FOV angle, one accumulation scan per step
        cur = (dist if dist is not None
               else jnp.full((cam.f.shape[0], 1), 0.5, dt))
        for _ in range(_FOV_GN_STEPS):
            terms = accumulate(
                lambda p, q, r, x_c, vis_c, dd=cur:
                _fov_gn_terms(cam, p, q, r, x_c, vis_c, f0, dd)
            )
            cur = _solve_fov_step(terms, cur, shared)
        return cur

    terms = accumulate(
        lambda p, q, r, x_c, vis_c:
        _distortion_lsq_terms(cam, p, q, r, x_c, vis_c, f0, model)
    )
    return _solve_distortion_lsq(terms, shared)


@partial(jax.jit, static_argnames=("f0", "axis", "config", "chunk_size"))
def bundle_adjust_chunked(
    x: jax.Array,
    init_X: jax.Array,
    init_K: jax.Array,
    init_R: jax.Array,
    init_t: jax.Array,
    f0: float = 1.0,
    visibility: jax.Array | None = None,
    axis: str = "x-right_z-forward",
    config: LMConfig = LMConfig(),
    chunk_size: int = 4096,
    init_c: jax.Array | None = None,
    init_nu: jax.Array | None = None,
    distortion: jax.Array | None = None,
) -> BAResult:
    """Drop-in alternative to ``bundle_adjust`` with an O(chunk) HBM
    footprint — the path for 100k-point / 1000-view scenes. The returned
    ``log`` carries the final damping (c, nu) so segmented runs resume via
    ``init_c``/``init_nu``."""
    dt = x.dtype
    npts, nf, _ = x.shape
    # Full visibility needs no dense mask: a (P, 1) column of ones
    # broadcasts through every masked reduction and costs nothing at the
    # million-point scale (a dense (P, F) f32 mask is 2 GB at 1M x 500).
    vis = (
        jnp.ones((npts, 1), dtype=dt)
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
        # refit-first alternation, exactly as the dense core (see
        # bundle_adjust); under Huber the refit weights by the IRLS
        # weights of the current distorted residuals, computed chunked.
        dist = fit_distortion_chunked(
            state0, x, vis, f0, chunk_size,
            shared=config.distortion_shared,
            huber_delta=(config.huber_delta
                         if resolve_robust(config.robust) is not None
                         else None),
            dist=dist, model=model,
            robust_kind=(resolve_robust(config.robust) or "huber"),
        )
        seg_cfg = dataclasses.replace(config, record_log=False)
        state0, _, c_seg, nu_seg, n_seg, _, _ = lm_optimize_chunked(
            x, state0, vis, free, f0, seg_cfg, chunk_size,
            init_c=c_seg, init_nu=nu_seg, dist=dist,
        )
        n_total = n_total + n_seg

    final, e, c_f, nu_f, n_iter, n_retries, scalar_log = lm_optimize_chunked(
        x, state0, vis, free, f0, config, chunk_size,
        init_c=c_seg, init_nu=nu_seg, dist=dist,
    )

    Xg, Rg, tg = restore_gauge(info, final.X, final.R, final.t)
    log = {"n_solver_retries": n_retries, "c": c_f, "nu": nu_f}
    if scalar_log is not None:
        log.update(scalar_log)
    return BAResult(
        X=Xg, K=build_K(final.f, final.u, f0), R=Rg, t=tg, error=e,
        n_iter=n_iter + n_total,
        log=log,
        distortion=dist,
    )
