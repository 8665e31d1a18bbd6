"""Point-sharded bundle adjustment (SPMD over a device mesh).

The reference is single-process NumPy (SURVEY.md §2, items 12-13: no
distributed anything); this module is the scale-out story for
*one huge scene*:

- the P (points) dimension of observations, 3D points, visibility, and all
  per-point Schur blocks is sharded over the ``points`` mesh axis;
- camera parameters (9F) are replicated;
- the only cross-device traffic per LM retry is the psum of the reduced
  camera system A (9F, 9F), its rhs b (9F,), and the scalar error — the
  direct analog of ring-attention-style partial-accumulator reduction
  (SURVEY.md §5, long-context row);
- the replicated (9F, 9F) solve runs on every device (cheap relative to
  the O(P (9F)^2) accumulation it follows).

Implementation: the exact same LM core as single-device
(``models/bundle_adjustment.lm_optimize``) run under ``shard_map`` with the
``points`` axis name plumbed into its psums — one code path, no fork.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import LMConfig
from ..models.bundle_adjustment import (
    BAResult,
    BAState,
    _DISTORTION_NCOLS,
    default_distortion,
    _huber_weights,
    build_K,
    bundle_adjust,  # noqa: F401 (re-exported convenience,
    fit_distortion,
    gauge_mask,
    intrinsics_from_K,
    lm_optimize,
    lm_step,
    normalize_gauge,
    resolve_distortion_model,
    resolve_robust,
    restore_gauge,
)

POINTS_AXIS = "points"


def sharded_bundle_adjust_chunked(
    mesh: Mesh,
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
    """Sharding composed with chunk-streaming: points are split over the
    mesh's ``points`` axis AND each device scans its shard in chunks —
    the million-point / multi-chip regime. Per LM retry the only
    cross-device traffic is the psum of the (9F, 9F) camera system.
    ``init_c``/``init_nu`` resume a segmented run (final values are in
    the returned ``log``).

    ``distortion`` / ``config.distortion_rounds``: the BAL radial model,
    with the same refit-first alternation as the single-device cores.
    (k1, k2) is replicated; the refit's (F, 5) normal terms are per-point
    sums, so each refit adds exactly one extra psum per round."""
    from ..models.bundle_adjustment_chunked import (
        fit_distortion_chunked,
        lm_optimize_chunked,
    )

    dt = x.dtype
    npts, nf, _ = x.shape
    vis = (
        jnp.ones((npts, nf), dtype=dt)
        if visibility is None
        else jnp.asarray(visibility, dtype=dt)
    )
    n_shards = mesh.shape[POINTS_AXIS]
    x_p, X_p, vis_p, n_orig = pad_points(x, init_X, vis, n_shards)

    X0, R0, t0, info = normalize_gauge(X_p, init_R, init_t, axis)
    free = gauge_mask(nf, axis, dt)

    c0 = jnp.asarray(config.init_damping if init_c is None else init_c, dt)
    nu0 = jnp.asarray(2.0 if init_nu is None else init_nu, dt)

    model_dist = distortion is not None or config.distortion_rounds > 0
    model = resolve_distortion_model(
        None if distortion is None else jnp.asarray(distortion),
        config.distortion_model,
    )
    dist0 = (
        default_distortion(model, nf, dt) if distortion is None
        else jnp.asarray(distortion, dt)
    )
    huber_delta = (config.huber_delta
                   if resolve_robust(config.robust) is not None else None)

    def run(x_l, X_l, f_r, u_r, t_r, R_r, vis_l, free_r, c_r, nu_r, dist_r):
        st0 = BAState(X=X_l, f=f_r, u=u_r, t=t_r, R=R_r)
        dist = dist_r if model_dist else None
        n_total = jnp.asarray(0)
        for _ in range(config.distortion_rounds):
            # refit-first alternation, exactly as bundle_adjust_chunked;
            # the refit's per-point normal terms psum over the shards.
            dist = fit_distortion_chunked(
                st0, x_l, vis_l, f0, chunk_size,
                shared=config.distortion_shared,
                huber_delta=huber_delta, dist=dist,
                axis_name=POINTS_AXIS, model=model,
                robust_kind=(resolve_robust(config.robust) or "huber"),
            )
            seg_cfg = dataclasses.replace(config, record_log=False)
            st0, _, c_r, nu_r, n_seg, _, _ = lm_optimize_chunked(
                x_l, st0, vis_l, free_r, f0, seg_cfg, chunk_size,
                axis_name=POINTS_AXIS, init_c=c_r, init_nu=nu_r, dist=dist,
            )
            n_total = n_total + n_seg
        final, e, c_f, nu_f, n_iter, n_retries, _ = lm_optimize_chunked(
            x_l, st0, vis_l, free_r, f0, config, chunk_size,
            axis_name=POINTS_AXIS, init_c=c_r, init_nu=nu_r, dist=dist,
        )
        dist_out = dist if model_dist else dist_r
        return (final.X, final.f, final.u, final.t, final.R, e, c_f, nu_f,
                n_iter + n_total, n_retries, dist_out)

    pt = P(POINTS_AXIS)
    rep = P()
    sharded = jax.jit(
        jax.shard_map(
            run,
            mesh=mesh,
            in_specs=(pt, pt, rep, rep, rep, rep, pt, rep, rep, rep, rep),
            out_specs=(pt,) + (rep,) * 10,
        )
    )
    f_in, u_in = intrinsics_from_K(init_K, f0)
    Xf, ff, uf, tf, Rf, e, c_f, nu_f, n_iter, n_retries, dist_f = sharded(
        x_p, X0, f_in, u_in, t0, R0, vis_p, free,
        c0, nu0, dist0,
    )

    Xg, Rg, tg = restore_gauge(info, Xf, Rf, tf)
    return BAResult(
        X=Xg[:n_orig],
        K=build_K(ff, uf, f0),
        R=Rg,
        t=tg,
        error=e,
        n_iter=n_iter,
        log={"n_solver_retries": n_retries, "c": c_f, "nu": nu_f},
        distortion=dist_f if model_dist else None,
    )


def pad_points(x: jax.Array, X: jax.Array, vis: jax.Array, n_shards: int):
    """Pad the points dimension of (x (P, F, 2), X (P, 3), vis (P, F)) to a
    multiple of ``n_shards``. Padded points get vis = 0 and X = mean(X)
    (their LM update is exactly zero — see the unseen-point guard in
    ``_compute_derivs``)."""
    npts = x.shape[0]
    rem = (-npts) % n_shards
    if rem == 0:
        return x, X, vis, npts
    x_pad = jnp.concatenate([x, jnp.zeros((rem,) + x.shape[1:], x.dtype)], axis=0)
    center = jnp.mean(X, axis=0)
    X_pad = jnp.concatenate([X, jnp.broadcast_to(center, (rem, 3))], axis=0)
    vis_pad = jnp.concatenate([vis, jnp.zeros((rem,) + vis.shape[1:], vis.dtype)], axis=0)
    return x_pad, X_pad, vis_pad, npts


def sharded_lm_step(
    mesh: Mesh,
    x: jax.Array,
    state: BAState,
    vis: jax.Array,
    free: jax.Array,
    c: jax.Array,
    f0: float = 1.0,
):
    """One damped LM step under shard_map (derivs -> Schur psum -> solve ->
    update -> new error). Building block for custom training loops and the
    multi-chip dry run."""

    def step(x_l, X_l, f_r, u_r, t_r, R_r, vis_l, free_r, c_r):
        st = BAState(X=X_l, f=f_r, u=u_r, t=t_r, R=R_r)
        new, e_now, e_new = lm_step(x_l, st, vis_l, free_r, f0, c_r, POINTS_AXIS)
        return new.X, new.f, new.u, new.t, new.R, e_now, e_new

    pt = P(POINTS_AXIS)
    rep = P()
    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(pt, pt, rep, rep, rep, rep, pt, rep, rep),
        out_specs=(pt, rep, rep, rep, rep, rep, rep),
    )
    Xn, fn, un, tn, Rn, e_now, e_new = sharded(
        x, state.X, state.f, state.u, state.t, state.R, vis, free, c
    )
    return BAState(X=Xn, f=fn, u=un, t=tn, R=Rn), e_now, e_new


@partial(jax.jit, static_argnames=("mesh", "f0", "axis", "config"))
def sharded_bundle_adjust(
    mesh: Mesh,
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
) -> BAResult:
    """Full bundle adjustment with the points dimension sharded over
    ``mesh``'s ``points`` axis. Same semantics as
    ``models.bundle_adjustment.bundle_adjust`` (same LM core, axis-name
    plumbed, same radial-distortion alternation); P is padded to a
    multiple of the shard count."""
    dt = x.dtype
    npts, nf, _ = x.shape
    vis = (
        jnp.ones((npts, nf), dtype=dt)
        if visibility is None
        else jnp.asarray(visibility, dtype=dt)
    )
    n_shards = mesh.shape[POINTS_AXIS]
    x_p, X_p, vis_p, n_orig = pad_points(x, init_X, vis, n_shards)

    X0, R0, t0, info = normalize_gauge(X_p, init_R, init_t, axis)
    free = gauge_mask(nf, axis, dt)

    model_dist = distortion is not None or config.distortion_rounds > 0
    model = resolve_distortion_model(
        None if distortion is None else jnp.asarray(distortion),
        config.distortion_model,
    )
    dist0 = (
        default_distortion(model, nf, dt) if distortion is None
        else jnp.asarray(distortion, dt)
    )

    def run(x_l, X_l, f_r, u_r, t_r, R_r, vis_l, free_r, dist_r):
        st0 = BAState(X=X_l, f=f_r, u=u_r, t=t_r, R=R_r)
        dist = dist_r if model_dist else None
        n_total = jnp.asarray(0)
        c_seg = None
        for _ in range(config.distortion_rounds):
            # refit-first alternation, exactly as bundle_adjust; the
            # refit's per-point normal terms psum over the shards.
            if resolve_robust(config.robust) is not None:
                vis_fit = _huber_weights(
                    st0, x_l, vis_l, f0, config.huber_delta, dist, model,
                    resolve_robust(config.robust),
                )
            else:
                vis_fit = vis_l
            dist = fit_distortion(
                st0, x_l, vis_fit, f0, shared=config.distortion_shared,
                axis_name=POINTS_AXIS, model=model, dist=dist,
            )
            seg_cfg = dataclasses.replace(config, record_log=False)
            st0, _, c_seg, _, n_seg, _ = lm_optimize(
                x_l, st0, vis_l, free_r, f0, seg_cfg,
                axis_name=POINTS_AXIS, init_c=c_seg, dist=dist,
            )
            n_total = n_total + n_seg
        final, e, _, _, n_iter, log = lm_optimize(
            x_l, st0, vis_l, free_r, f0, config, axis_name=POINTS_AXIS,
            init_c=c_seg, dist=dist,
        )
        dist_out = dist if model_dist else dist_r
        return (final.X, final.f, final.u, final.t, final.R, e,
                n_iter + n_total, log["n_solver_retries"], dist_out)

    pt = P(POINTS_AXIS)
    rep = P()
    sharded = jax.shard_map(
        run,
        mesh=mesh,
        in_specs=(pt, pt, rep, rep, rep, rep, pt, rep, rep),
        out_specs=(pt, rep, rep, rep, rep, rep, rep, rep, rep),
    )
    f_in, u_in = intrinsics_from_K(init_K, f0)
    Xf, ff, uf, tf, Rf, e, n_iter, n_retries, dist_f = sharded(
        x_p, X0, f_in, u_in, t0, R0, vis_p, free, dist0
    )

    Xg, Rg, tg = restore_gauge(info, Xf, Rf, tf)
    return BAResult(
        X=Xg[:n_orig],
        K=build_K(ff, uf, f0),
        R=Rg,
        t=tg,
        error=e,
        n_iter=n_iter,
        log={"n_solver_retries": n_retries},
        distortion=dist_f if model_dist else None,
    )
