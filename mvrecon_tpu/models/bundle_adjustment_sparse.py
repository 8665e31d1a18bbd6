"""Sparse observation-list bundle adjustment — O(n_obs) memory.

Every other core represents visibility as a dense (P, F) mask over dense
(P, F, 2) observations — faithful to the reference's contract
(``/root/reference/lib/bundle_adjustment.py:56-59``) and right up to
~20% fill, but memory scales as P*F rather than n_observations. Real
BAL-class problems (thousands of cameras, ~0.1-1% fill) need the layout
production BA systems use: a flat observation list.

Accelerator-native design (this is NOT a sparse-matrix port):

- **Layout**: three static-shape arrays sorted by point id —
  ``point_idx (N,) int32``, ``cam_idx (N,) int32``, ``xy (2, N)``.
  Static N, static everything: one compile per problem shape. No
  camera sort exists: camera-side reductions contract a per-chunk
  one-hot against the point-sorted order (below).
- **Per-observation work is the virtual-camera trick**: the observation
  list is treated as ONE point seen by N per-observation "cameras"
  (camera parameters gathered per observation), so the whole model-
  generic distortion chain (six families), the robust-loss family, and
  the residual formulas of the dense core apply verbatim on (1, C)-
  chunk views — zero formula duplication.
- **Point side**: per-point 3x3 blocks and gradients via sorted
  ``segment_sum`` over point ids (points are the sorted axis).
- **Camera side**: the reduced camera (Schur) system is NEVER formed.
  The damped Schur complement S = G^ - F^T E^-1 F is applied matrix-
  free: each matvec is two wide gathers, two rowwise dots, one sorted
  point-segment-sum, a batched 3x3 solve, and one camera reduction —
  O(n_obs) FLOPs and bytes. A block-Jacobi (SCHUR_JACOBI) 9x9
  preconditioner built once per retry makes PCG converge in tens of
  iterations. This is the ITERATIVE_SCHUR architecture of production
  BA solvers, recast as dense XLA programs: gathers move k elements
  per index through one stacked (k, M)-table ``take`` (one wide gather
  instead of k thin 1-D gathers), and every camera-side segment
  reduction is a chunked ONE-HOT MATMUL (a contraction instead of a
  scatter-add; kills the camera argsort entirely). Point-side
  reductions stay sorted ``segment_sum``. Whether the one-hot
  reduction still beats ``segment_sum`` on the GPU is an open
  measurement.
- **LM protocol**: identical to the dense/chunked cores (Nielsen or
  reference damping, accept test, never-accepted stop, gauge handling
  via ``normalize_gauge``/``gauge_mask``), so segmented resume and the
  stopping contract (reference ``:186-191``) carry over.

**Component-major layout.** Every per-observation array in this core
is **transposed**: the big N axis is minormost and the small component
axis leads, so no backend can tile-pad the small axis up to a vector
width (a padded (N, 3) layout would multiply 10M observations' factor
arrays by tens). Concretely: ``SparseObs.xy`` is ``(2, N)``; Jacobian factors
are ``a1, a2 (3, N)`` / ``b1, b2 (9, N)``; per-point quantities are
row stacks ``(3, P)`` with the symmetric 3x3 point blocks held as six
``(P,)`` rows (``_sym3_*``); segment reductions run row-by-row over
1-D arrays. Rank-3 per-observation intermediates (the 9x9 camera-block
outer products, the distortion chain's (C, k) evaluations) are bounded
by ``obs_chunk`` inside ``lax.scan``.

Memory: factors resident per retry are 24 rows of (N,) floats (a1, a2,
b1, b2) plus six (P,) point-block rows — ~1 GB of *useful* bytes at
N=10M, P=1M, and the tiled footprint is within 2.7x of useful (vs 42x
for the naive (N, k) layout). A dense mask at that scale would be
16 GB for the observations alone.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from ..config import HIGHEST, STATE_HIGHEST, LMConfig
from ..ops.linalg import inv9_spd
from .bundle_adjustment import (
    BAResult,
    BAState,
    _apply_distortion_chain,
    _apply_update,
    _distorted_residual,
    _psum,
    _distortion_lsq_terms,
    _fov_gn_terms,
    _full_opencv_lsq_terms,
    _solve_distortion_lsq,
    _solve_fov_step,
    _solve_full_opencv_round,
    FULL_OPENCV_ALTERNATIONS,
    _FOV_GN_STEPS,
    build_K,
    default_distortion,
    distortion_nterms,
    gauge_mask,
    intrinsics_from_K,
    normalize_gauge,
    resolve_distortion_model,
    resolve_robust,
    restore_gauge,
    robust_weight,
)


class SparseObs(NamedTuple):
    """Observation list sorted ascending by ``point_idx``.

    ``xy`` is **lane-major** ``(2, N)`` (see the module docstring: an
    (N, 2) layout can tile-pad the 2-axis to a full vector width).
    ``weights`` are optional per-observation confidences (multiplied into
    the IRLS weights); padding observations carry weight 0.
    """

    point_idx: jax.Array  # (N,) int32, sorted ascending
    cam_idx: jax.Array  # (N,) int32
    xy: jax.Array  # (2, N) lane-major
    weights: jax.Array  # (N,)

    @property
    def n_obs(self) -> int:
        return self.point_idx.shape[0]


def make_sparse_obs(point_idx, cam_idx, xy, weights=None) -> SparseObs:
    """Host-side constructor: sorts by point id (stable, so per-point
    camera order is preserved), validates shapes, and stores ``xy``
    lane-major. Accepts ``xy`` as (N, 2) (the host convention) or
    already-transposed (2, N)."""
    point_idx = np.asarray(point_idx)
    cam_idx = np.asarray(cam_idx)
    xy = np.asarray(xy)
    n = point_idx.shape[0] if point_idx.ndim else 0
    if xy.shape == (2, n) and n != 2:
        xy = np.ascontiguousarray(xy.T)
    if not (point_idx.shape == cam_idx.shape == xy.shape[:-1]) or xy.shape[-1] != 2:
        raise ValueError(
            f"inconsistent observation shapes: {point_idx.shape}, "
            f"{cam_idx.shape}, {xy.shape}"
        )
    w = np.ones(point_idx.shape, xy.dtype) if weights is None else np.asarray(weights)
    order = np.argsort(point_idx, kind="stable")
    return SparseObs(
        point_idx=jnp.asarray(point_idx[order], jnp.int32),
        cam_idx=jnp.asarray(cam_idx[order], jnp.int32),
        xy=jnp.asarray(np.ascontiguousarray(xy[order].T)),
        weights=jnp.asarray(w[order], xy.dtype),
    )


def dense_to_sparse_obs(x: np.ndarray, visibility: np.ndarray) -> SparseObs:
    """(P, F, 2) dense observations + (P, F) mask -> observation list
    (the bridge the parity tests use; point-major order = sorted)."""
    x = np.asarray(x)
    vis = np.asarray(visibility)
    pi, ci = np.nonzero(vis > 0)
    return SparseObs(
        point_idx=jnp.asarray(pi, jnp.int32),
        cam_idx=jnp.asarray(ci, jnp.int32),
        xy=jnp.asarray(np.ascontiguousarray(x[pi, ci].T)),
        weights=jnp.asarray(vis[pi, ci], x.dtype),
    )


def _calc_pmat(cam: BAState, f0: float) -> jax.Array:
    """(F, 3, 4) camera matrices (the camera half of the dense core's
    ``calc_pqr``, reference ``:291-307``)."""
    K = build_K(cam.f, cam.u, f0)
    rt = jnp.swapaxes(cam.R, -1, -2)
    trans = -jnp.einsum("fij,fj->fi", rt, cam.t, precision=STATE_HIGHEST)
    return jnp.einsum(
        "fij,fjk->fik", K, jnp.concatenate([rt, trans[..., None]], axis=-1),
        precision=STATE_HIGHEST,
    )


# --------------------------------------------------------------------------
# lane-major building blocks: symmetric 3x3 blocks as six (…,) rows in the
# order (00, 11, 22, 01, 02, 12); per-row sorted segment reductions
# --------------------------------------------------------------------------


# "Rows" are tuples of 1-D arrays — a k-row stack held as k separate
# (N,)/(P,) vectors. 1-D arrays admit only one layout, so XLA can
# never insert a transposed layout-copy that pads the small axis to a
# vector width. All row algebra is unrolled Python
# loops over k <= 12 — XLA fuses the resulting elementwise graphs.
Rows = tuple


def _rows_gather(rows: Rows, idx: jax.Array) -> Rows:
    """Row-stack gather: (k x (M,), (N,) ids) -> k x (N,).

    ONE wide gather (`take` along the lane axis of the stacked (k, M)
    table) instead of k thin 1-D gathers: gather cost is largely
    per-INDEX, so moving k elements per index amortizes it k ways.
    The (k, M) stack of
    loop-invariant rows is hoisted by XLA; the (k, N) result is
    lane-major, so no tile-padding blowup."""
    if len(rows) == 1:
        return (rows[0][idx],)
    g = jnp.take(jnp.stack(rows), idx, axis=1)
    return tuple(g[i] for i in range(g.shape[0]))


def _cols_rows(a: jax.Array) -> Rows:
    """(M, k) 2-D array -> k column rows ((M,) each; M is F-sized)."""
    return tuple(a[:, i] for i in range(a.shape[1]))


def _sym3_inv(e: Rows) -> Rows:
    """Closed-form inverse of symmetric 3x3 blocks held as six rows in
    the order (00, 11, 22, 01, 02, 12) — the lane-major twin of
    ``ops.linalg.inv3x3``."""
    a, d, f, b, c, ee = e
    adj00 = d * f - ee * ee
    adj01 = c * ee - b * f
    adj02 = b * ee - c * d
    adj11 = a * f - c * c
    adj12 = b * c - a * ee
    adj22 = a * d - b * b
    det = a * adj00 + b * adj01 + c * adj02
    inv_det = 1.0 / det
    return tuple(adj * inv_det
                 for adj in (adj00, adj11, adj22, adj01, adj02, adj12))


def _sym3_matvec(e: Rows, v: Rows) -> Rows:
    """Six symmetric rows @ three vector rows -> three rows."""
    return (
        e[0] * v[0] + e[3] * v[1] + e[4] * v[2],
        e[3] * v[0] + e[1] * v[1] + e[5] * v[2],
        e[4] * v[0] + e[5] * v[1] + e[2] * v[2],
    )


def _seg_rows(rows: Rows, ids: jax.Array, n: int) -> Rows:
    """Per-row sorted segment reduction: k x (N,) -> k x (n,)."""
    return tuple(
        jax.ops.segment_sum(r, ids, num_segments=n, indices_are_sorted=True)
        for r in rows
    )


def _dot_rows(a: Rows, b: Rows) -> jax.Array:
    """Row-wise dot: sum_i a_i * b_i -> (N,)."""
    acc = a[0] * b[0]
    for i in range(1, len(a)):
        acc = acc + a[i] * b[i]
    return acc


def _axpy_rows(s1: jax.Array, a: Rows, s2: jax.Array, b: Rows) -> Rows:
    """s1 * a + s2 * b row-wise (s broadcast scalars or (N,))."""
    return tuple(s1 * ai + s2 * bi for ai, bi in zip(a, b))


def _cross_rows(a: Rows, b: Rows) -> Rows:
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def _rows_to_flat(rows: Rows) -> jax.Array:
    """Nine (F,) camera rows -> (9F,) camera-major flat vector (the
    (F, 9) intermediate is F-sized — harmless)."""
    return jnp.stack(rows, -1).reshape(-1)


def _chain_state(f_g: jax.Array, u_g: jax.Array) -> BAState:
    """Per-observation virtual-camera state for the distortion chain —
    which reads only ``f`` and ``u`` (grep-checked); the other fields are
    scalar placeholders so no (C, 3, 3)-class gather ever exists."""
    z = jnp.zeros((), f_g.dtype)
    return BAState(X=z, f=f_g, u=u_g, t=z, R=z)


def _prep_chunks(a: jax.Array, chunk: int, nch: int) -> jax.Array:
    """Zero-pad a 1-D array to nch*chunk and expose the chunk axis
    first: (N,) -> (nch, C)."""
    a = jnp.pad(a, (0, nch * chunk - a.shape[-1]))
    return a.reshape(nch, chunk)


def _scan_obs_chunks(body, init, row_arrays, obs_chunk):
    """Scan ``body(acc, chunk_of_columns)`` over column chunks of a
    pytree of (N,) arrays, zero-padding the tail. Returns (final acc,
    stacked per-chunk outputs matching body's second return)."""
    leaves = jax.tree.leaves(row_arrays)
    n = leaves[0].shape[-1]
    nch = -(-n // obs_chunk)
    acc, ys = jax.lax.scan(
        body, init,
        jax.tree.map(lambda a: _prep_chunks(a, obs_chunk, nch), row_arrays),
    )
    return acc, ys


def _pqr_t(cam: BAState, X_r: Rows, obs: SparseObs, f0: float):
    """Per-observation homogeneous coordinates (p, q, r): the camera
    matrix is gathered as twelve (N,) rows, never (N, 3, 4)."""
    pi, ci = obs.point_idx, obs.cam_idx
    nf = cam.f.shape[0]
    pm = _cols_rows(_calc_pmat(cam, f0).reshape(nf, 12))  # 12 x (F,)
    pm_g = _rows_gather(pm, ci)  # 12 x (N,)
    X_g = _rows_gather(X_r, pi)  # 3 x (N,)
    p = pm_g[0] * X_g[0] + pm_g[1] * X_g[1] + pm_g[2] * X_g[2] + pm_g[3]
    q = pm_g[4] * X_g[0] + pm_g[5] * X_g[1] + pm_g[6] * X_g[2] + pm_g[7]
    r = pm_g[8] * X_g[0] + pm_g[9] * X_g[1] + pm_g[10] * X_g[2] + pm_g[11]
    return pm_g, X_g, p, q, r


def _cam_factor_rows(cam: BAState, f0: float):
    """Every F-sized row the factor formulas gather per observation:
    (12 pm rows, f, 2 u rows, 3x3 rotation-column rows, 3 t rows)."""
    nf = cam.f.shape[0]
    pm = _cols_rows(_calc_pmat(cam, f0).reshape(nf, 12))
    return (
        pm, cam.f, _cols_rows(cam.u),
        _cols_rows(cam.R[:, :, 0]), _cols_rows(cam.R[:, :, 1]),
        _cols_rows(cam.R[:, :, 2]), _cols_rows(cam.t),
    )


def _factor_cols(camrows, X_t: Rows, pi, ci, xy0, xy1, w, f0,
                 huber_delta=None, dist=None, model=None,
                 robust_kind: str = "huber"):
    """Per-observation residuals and rank-2 Jacobian factors on an
    arbitrary column slice of the observation list — shared by the
    stored-factor path (full-N / distortion-chunk views) and the
    rematerialization path (recomputed per chunk inside every pass).

    Same math as the dense core's ``_compute_derivs`` (reference
    ``:291-427``), evaluated per observation via row gathers — rotation
    *columns* are gathered as rows, never an (N, 3, 3) tensor. All ops
    are elementwise or gathers, so results are bitwise identical
    however the caller slices the columns. ``dist``, when given, runs
    the model-generic distortion chain directly on the slice (the
    caller bounds the slice so the chain's (C, k) views stay small).
    """
    pm, f, u, r0, r1, r2, t = camrows
    pm_g = _rows_gather(pm, ci)  # 12 x (C,)
    X_g = _rows_gather(X_t, pi)  # 3 x (C,)
    p = pm_g[0] * X_g[0] + pm_g[1] * X_g[1] + pm_g[2] * X_g[2] + pm_g[3]
    q = pm_g[4] * X_g[0] + pm_g[5] * X_g[1] + pm_g[6] * X_g[2] + pm_g[7]
    r = pm_g[8] * X_g[0] + pm_g[9] * X_g[1] + pm_g[10] * X_g[2] + pm_g[11]
    r = jnp.where(w > 0, r, jnp.ones_like(r))  # 0*inf guard (padding)

    f_g = f[ci]
    u_g = _rows_gather(u, ci)  # 2 x (C,)
    r0_g = _rows_gather(r0, ci)  # rotation columns
    r1_g = _rows_gather(r1, ci)
    r2_g = _rows_gather(r2, ci)
    t_g = _rows_gather(t, ci)

    res_p = p / r - xy0 / f0
    res_q = q / r - xy1 / f0

    # point rows: dX of (p, q, r) are the pmat rows (reference :309-322)
    dpdX, dqdX, drdX = pm_g[0:3], pm_g[4:7], pm_g[8:11]
    inv_r2 = 1.0 / (r * r)
    a1 = tuple((r * dp_ - p * dr_) * inv_r2 for dp_, dr_ in zip(dpdX, drdX))
    a2 = tuple((r * dq_ - q * dr_) * inv_r2 for dq_, dr_ in zip(dqdX, drdX))

    # camera rows, per observation (reference :324-398)
    dpdf = (p - (u_g[0] / f0) * r) / f_g
    dqdf = (q - (u_g[1] / f0) * r) / f_g
    zeros = jnp.zeros_like(r)
    r_f0 = r / f0
    dpdt = tuple(-(f_g * r0_ + u_g[0] * r2_) for r0_, r2_ in zip(r0_g, r2_g))
    dqdt = tuple(-(f_g * r1_ + u_g[1] * r2_) for r1_, r2_ in zip(r1_g, r2_g))
    drdt = tuple(-f0 * r2_ for r2_ in r2_g)
    x_m_t = tuple(xg - tg for xg, tg in zip(X_g, t_g))
    dpdw = _cross_rows(tuple(-v for v in dpdt), x_m_t)
    dqdw = _cross_rows(tuple(-v for v in dqdt), x_m_t)
    drdw = _cross_rows(tuple(-v for v in drdt), x_m_t)
    dp = (dpdf, r_f0, zeros) + dpdt + dpdw  # 9 rows
    dq = (dqdf, zeros, r_f0) + dqdt + dqdw
    dr = (zeros, zeros, zeros) + drdt + drdw
    b1 = tuple((r * dp_ - p * dr_) * inv_r2 for dp_, dr_ in zip(dp, dr))
    b2 = tuple((r * dq_ - q * dr_) * inv_r2 for dq_, dr_ in zip(dq, dr))

    if dist is not None:
        dist_g = _rows_gather(_cols_rows(dist), ci)  # k x (C,)
        res_p, res_q, a1m, a2m, b1m, b2m = _apply_distortion_chain(
            _chain_state(f_g, jnp.stack(u_g, -1)), p[None], q[None],
            r[None], f0, jnp.stack(dist_g, -1),
            res_p[None], res_q[None],
            jnp.stack(a1, -1)[None], jnp.stack(a2, -1)[None],
            jnp.stack(b1, -1)[None], jnp.stack(b2, -1)[None], model,
        )
        res_p, res_q = res_p[0], res_q[0]
        a1, a2 = _cols_rows(a1m[0]), _cols_rows(a2m[0])
        b1, b2 = _cols_rows(b1m[0]), _cols_rows(b2m[0])

    if huber_delta is not None:
        mag = jnp.sqrt(res_p**2 + res_q**2)
        w = w * robust_weight(mag, huber_delta, robust_kind)
    return a1, a2, b1, b2, res_p, res_q, w


def _obs_factors(cam: BAState, X_t: jax.Array, obs: SparseObs, f0: float,
                 huber_delta=None, dist=None, model: str | None = None,
                 robust_kind: str = "huber", obs_chunk: int = 1 << 16,
                 factor_dtype=None):
    """Per-observation residuals and rank-2 Jacobian factors, lane-major
    — the STORED-factor path: full-N (3, N)/(9, N) row tuples that stay
    live across the CG solve.

    Returns (a1, a2 (3, N); b1, b2 (9, N); res_p, res_q (N,); w (N,))
    with w the effective weight (input weight x IRLS robust weight) and
    ``X_t`` the (3, P) row-stacked points. The math lives in
    :func:`_factor_cols`; with a distortion chain the whole computation
    runs inside a ``lax.scan`` over ``obs_chunk`` columns, so the
    chain's (C, k) views stay bounded.

    ``factor_dtype`` (e.g. ``jnp.bfloat16``) stores the returned a/b
    rows narrower — the capacity lever: the 24 factor rows dominate the
    core's per-observation residency (they stay live across the whole
    CG solve), and the casts fuse into the producing elementwise graph,
    so the f32 rows never hit HBM at full N. Residuals, weights, and
    everything P-/F-sized stay f32; consumers upcast per use (see
    ``lm_optimize_sparse``'s note on the numerics).
    """
    camrows = _cam_factor_rows(cam, f0)

    def narrow(rows: Rows) -> Rows:
        if factor_dtype is None:
            return rows
        return tuple(r.astype(factor_dtype) for r in rows)

    if dist is None:
        a1, a2, b1, b2, res_p, res_q, w = _factor_cols(
            camrows, X_t, obs.point_idx, obs.cam_idx, obs.xy[0], obs.xy[1],
            obs.weights, f0, huber_delta, None, model, robust_kind,
        )
        return (narrow(a1), narrow(a2), narrow(b1), narrow(b2),
                res_p, res_q, w)

    def body(_, cols):
        pi_c, ci_c, x_c, y_c, w_c = cols
        a1, a2, b1, b2, rp, rq, w_eff = _factor_cols(
            camrows, X_t, pi_c, ci_c, x_c, y_c, w_c, f0,
            huber_delta, dist, model, robust_kind,
        )
        return (), (narrow(a1), narrow(a2), narrow(b1), narrow(b2),
                    rp, rq, w_eff)

    n = obs.n_obs
    _, ys = _scan_obs_chunks(
        body, (),
        (obs.point_idx, obs.cam_idx, obs.xy[0], obs.xy[1], obs.weights),
        min(obs_chunk, max(n, 1)),
    )

    def unchunk(y):  # (nch, C) leaves -> (N,) leaves
        return jax.tree.map(lambda a: a.reshape(-1)[:n], y)

    a1, a2, b1, b2, res_p, res_q, w = (unchunk(y) for y in ys)
    return a1, a2, b1, b2, res_p, res_q, w


def _residuals_t(cam: BAState, X_t: jax.Array, obs: SparseObs, w: jax.Array,
                 f0: float, dist, model, obs_chunk: int = 1 << 16):
    """(res_p, res_q) (N,) at (cam, X_t) — the cheap residual-only pass
    (no Jacobian factors); the distortion chain runs chunk-scanned."""
    ci = obs.cam_idx
    _, _, p, q, r = _pqr_t(cam, X_t, obs, f0)
    r = jnp.where(w > 0, r, jnp.ones_like(r))
    if dist is None:
        return p / r - obs.xy[0] / f0, q / r - obs.xy[1] / f0

    f_g = cam.f[ci]
    u_g = _rows_gather(_cols_rows(cam.u), ci)
    dist_g = _rows_gather(_cols_rows(dist), ci)

    def res_chunk(_, cols):
        p_c, q_c, r_c, x_c, y_c, f_c, u_c, d_c = cols
        rp, rq = _distorted_residual(
            _chain_state(f_c, jnp.stack(u_c, -1)), p_c[None], q_c[None],
            r_c[None], jnp.stack([x_c, y_c], -1)[None], f0,
            jnp.stack(d_c, -1), model,
        )
        return (), (rp[0], rq[0])

    n = p.shape[0]
    _, (rp, rq) = _scan_obs_chunks(
        res_chunk, (), (p, q, r, obs.xy[0], obs.xy[1], f_g, u_g, dist_g),
        min(obs_chunk, max(n, 1)),
    )
    return rp.reshape(-1)[:n], rq.reshape(-1)[:n]


def _trial_error(cam: BAState, X_t: jax.Array, obs: SparseObs, w: jax.Array,
                 f0: float, dist, model, axis_name=None,
                 obs_chunk: int = 1 << 16):
    """Sum of w-weighted squared residuals at (cam, X_t); ``w`` carries
    the IRLS weights of the *current* state (chunked-core convention)."""
    res_p, res_q = _residuals_t(cam, X_t, obs, w, f0, dist, model, obs_chunk)
    return _psum(jnp.sum(w * (res_p**2 + res_q**2)), axis_name)


def _cam_chunk(nf: int, obs_chunk: int, n: int) -> int:
    """Chunk size for one-hot camera reductions: the (C, F) one-hot
    must stay ~<= 64 MB f32 (and never exceed the array length)."""
    return min(max(256, min(obs_chunk, (1 << 24) // max(nf, 1))),
               max(n, 1))


def _onehot(ci_c: jax.Array, nf: int, dt) -> jax.Array:
    return (ci_c[:, None]
            == jnp.arange(nf, dtype=ci_c.dtype)[None, :]).astype(dt)


def _cam_sum_rows(rows, ci: jax.Array, nf: int, obs_chunk: int,
                  axis_name=None):
    """Per-camera sum of per-observation rows: k x (N,) -> k x (F,) (or
    a single (N,) -> (F,)) as chunked ONE-HOT MATMULS.

    A (C, F) one-hot against the (C, k) row stack turns the
    scatter-add that segment_sum lowers to into a dense contraction
    (on the GPU the comparison with ``segment_sum`` is still to be
    measured). The one-hot entries are exact
    in any dtype; HIGHEST precision keeps f32 summand accuracy. No
    camera-sorted permutation is needed (killing the former full-N
    argsort + per-row permutation gathers)."""
    single = not isinstance(rows, tuple)
    rows_t = (rows,) if single else rows
    k = len(rows_t)
    n = ci.shape[-1]
    dt = rows_t[0].dtype
    if dt == jnp.bfloat16:
        dt = jnp.float32
    chunk = _cam_chunk(nf, obs_chunk, n)
    nch = -(-n // chunk)
    arange = jnp.arange(chunk, dtype=jnp.int32)

    def body(kk, acc):
        start = jnp.minimum(kk * chunk, n - chunk)
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, start, chunk, axis=-1)
        fresh = (start + arange) >= kk * chunk  # tail-overlap guard
        data = jnp.stack(
            [jnp.where(fresh, sl(r), 0).astype(dt) for r in rows_t], -1
        )  # (C, k)
        oh = _onehot(sl(ci), nf, dt)
        return acc + jnp.einsum("cf,ck->fk", oh, data, precision=HIGHEST)

    init = jnp.zeros((nf, k), dt)
    if axis_name is not None:  # shard_map: the body folds varying data
        from .bundle_adjustment_chunked import _vary

        init = _vary(init, axis_name)
    acc = jax.lax.fori_loop(0, nch, body, init)
    out = tuple(acc[:, i] for i in range(k))
    return out[0] if single else out


def _camera_blocks_scan(b1, b2, alpha, w2, ci, nf, obs_chunk,
                        axis_name=None):
    """(F, 9, 9) camera blocks G and the preconditioner's correction
    C_c = sum_n alpha11 b1 b1^T + alpha12 (b1 b2^T + b2 b1^T) + alpha22
    b2 b2^T, accumulated over observation chunks so the (chunk, 9, 9)
    outer products never materialize at full N. ``b1``/``b2`` arrive as
    nine (N,) rows (possibly narrow — see ``factor_dtype``; the chunk
    stacks upcast, so products and accumulators stay full-width). The
    per-camera reduction is a one-hot contraction per chunk (see
    :func:`_cam_sum_rows`) — chunks slice the point-sorted order
    directly, no camera sort."""
    dt = w2.dtype
    n = b1[0].shape[-1]
    chunk = _cam_chunk(nf, obs_chunk, n)
    nch = -(-n // chunk)
    arange = jnp.arange(chunk, dtype=jnp.int32)

    def body(kk, acc):
        g_acc, c_acc = acc
        start = jnp.minimum(kk * chunk, n - chunk)
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, start, chunk, axis=-1)
        fresh = (start + arange) >= kk * chunk
        w2c = jnp.where(fresh, sl(w2), 0)
        b1c = jnp.stack([sl(r) for r in b1], -1).astype(dt)  # (C, 9)
        b2c = jnp.stack([sl(r) for r in b2], -1).astype(dt)
        a11c, a12c, a22c = (jnp.where(fresh, sl(a), 0) for a in alpha)
        o11 = jnp.einsum("ni,nj->nij", b1c, b1c, precision=HIGHEST)
        o12 = jnp.einsum("ni,nj->nij", b1c, b2c, precision=HIGHEST)
        o22 = jnp.einsum("ni,nj->nij", b2c, b2c, precision=HIGHEST)
        g_c = w2c[:, None, None] * (o11 + o22)
        c_c = (
            a11c[:, None, None] * o11
            + a12c[:, None, None] * (o12 + jnp.swapaxes(o12, -1, -2))
            + a22c[:, None, None] * o22
        )
        oh = _onehot(sl(ci), nf, dt)
        seg = lambda v: jnp.einsum("cf,cij->fij", oh, v, precision=HIGHEST)
        return (g_acc + seg(g_c), c_acc + seg(c_c))

    from .bundle_adjustment_chunked import _vary

    init = _vary(
        (jnp.zeros((nf, 9, 9), dt), jnp.zeros((nf, 9, 9), dt)), axis_name
    )
    return jax.lax.fori_loop(0, nch, body, init)


def _build_sparse_system(cam, X, obs, free, f0, c,
                         huber_delta, dist, model, robust_kind, obs_chunk,
                         axis_name=None, factor_dtype=None):
    """One damped build: point blocks + gradients + camera blocks +
    block-Jacobi preconditioner + rhs. Returns everything the CG solve
    and back-substitution need, plus the weighted error at the current
    state.

    With ``axis_name`` (inside shard_map over a point-partitioned
    observation list) the camera-side accumulations (d_F, matG, the
    preconditioner correction, rhs, error) psum across devices;
    everything point-side stays shard-local — the same split as the
    chunked core's sharding (``parallel/sharded_ba.py``)."""
    npts, nf = X[0].shape[-1], cam.f.shape[0]
    dt = X[0].dtype
    a1, a2, b1, b2, res_p, res_q, w = _obs_factors(
        cam, X, obs, f0, huber_delta, dist, model, robust_kind, obs_chunk,
        factor_dtype,
    )
    e_now = _psum(jnp.sum(w * (res_p**2 + res_q**2)), axis_name)
    w2 = 2.0 * w
    pi = obs.point_idx

    # point gradient and blocks (reference :437-446 / :463-500) — the
    # symmetric 3x3 blocks live as six (P,) rows (order 00,11,22,01,02,12)
    d_P = _seg_rows(
        tuple(w2 * (res_p * a1i + res_q * a2i)
              for a1i, a2i in zip(a1, a2)), pi, npts)  # 3 x (P,)
    # a-row self-products upcast before multiplying (narrow x narrow
    # would round the product); the upcast rows are fusion transients
    a1u = tuple(r.astype(dt) for r in a1)
    a2u = tuple(r.astype(dt) for r in a2)
    e_rows = (
        a1u[0] * a1u[0] + a2u[0] * a2u[0],
        a1u[1] * a1u[1] + a2u[1] * a2u[1],
        a1u[2] * a1u[2] + a2u[2] * a2u[2],
        a1u[0] * a1u[1] + a2u[0] * a2u[1],
        a1u[0] * a1u[2] + a2u[0] * a2u[2],
        a1u[1] * a1u[2] + a2u[1] * a2u[2],
    )
    matE6 = _seg_rows(tuple(w2 * e for e in e_rows), pi, npts)  # 6 x (P,)
    seen = (jax.ops.segment_sum(w, pi, num_segments=npts,
                                indices_are_sorted=True) > 0).astype(dt)
    # unseen points get identity blocks (diag rows 1, off-diag 0)
    unseen = 1.0 - seen
    matE6 = tuple(e + unseen if i < 3 else e for i, e in enumerate(matE6))
    matEc6 = tuple(e * (1.0 + c) if i < 3 else e
                   for i, e in enumerate(matE6))
    einv6 = _sym3_inv(matEc6)

    # camera gradient d_F (9F,)
    ci = obs.cam_idx
    d_F = _psum(
        _rows_to_flat(_cam_sum_rows(
            tuple(w2 * (res_p * b1i + res_q * b2i)
                  for b1i, b2i in zip(b1, b2)), ci, nf, obs_chunk,
            axis_name,
        )),
        axis_name,
    ) * free

    # alpha scalars for the SCHUR_JACOBI correction: a_i^T Einv a_j per
    # observation (Einv gathered per point). The w2 weighting enters each
    # F_n = w2 (a1 b1^T + a2 b2^T) twice but Einv once: fold w2 * w2 into
    # alpha (w2 is already inside matE, hence inside Einv exactly once).
    einv_g = _rows_gather(einv6, pi)  # 6 x (N,)
    ea1 = _sym3_matvec(einv_g, a1)
    ea2 = _sym3_matvec(einv_g, a2)
    al11 = w2 * w2 * _dot_rows(a1, ea1)
    al12 = w2 * w2 * _dot_rows(a1, ea2)
    al22 = w2 * w2 * _dot_rows(a2, ea2)

    matG, corr = _camera_blocks_scan(
        b1, b2, (al11, al12, al22), w2, ci, nf, obs_chunk,
        axis_name,
    )
    matG = _psum(matG, axis_name)
    corr = _psum(corr, axis_name)
    matGc = matG + c * matG * jnp.eye(9, dtype=dt)[None]
    seen_c = (
        _psum(_cam_sum_rows(w, ci, nf, obs_chunk, axis_name),
              axis_name) > 0
    ).astype(dt)

    # block-Jacobi preconditioner: the true Schur diagonal blocks,
    # gauge-projected then inverted (fixed coords become identity rows)
    m_blocks = matGc - corr
    free_b = free.reshape(nf, 9)
    m_blocks = m_blocks * (free_b[:, :, None] * free_b[:, None, :])
    fix = 1.0 - free_b
    m_blocks = m_blocks + jnp.eye(9, dtype=dt)[None] * (
        fix + (1.0 - seen_c)[:, None] * free_b
    )[:, :, None]
    m_inv = inv9_spd(m_blocks)

    # rhs: b = F^T Einv d_P - d_F (gauge-masked), reference :532-560
    wp = _sym3_matvec(einv6, d_P)  # 3 x (P,)
    wp_g = _rows_gather(wp, pi)
    r1 = w2 * _dot_rows(a1, wp_g)
    r2 = w2 * _dot_rows(a2, wp_g)
    b_f = _psum(
        _rows_to_flat(_cam_sum_rows(
            _axpy_rows(r1, b1, r2, b2), ci, nf, obs_chunk, axis_name
        )),
        axis_name,
    )
    rhs = (b_f - d_F) * free

    diag_g = jnp.diagonal(matG, axis1=-2, axis2=-1).reshape(-1)  # undamped

    factors = (a1, a2, b1, b2, w2, einv6, d_P)
    return factors, matGc, m_inv, rhs, d_F, diag_g, e_now, matE6, seen_c


# --------------------------------------------------------------------------
# rematerialization mode (factor_mode="recompute"): the 24 per-observation
# factor rows are NEVER stored — every pass (build, each CG matvec side,
# back-substitution, trial error) recomputes them chunk-by-chunk from the
# O(P)/O(F) state via _factor_cols. Per-observation residency drops from
# ~120 B (stored f32 rows) to the ~20 B of the observation list itself, so
# a single chip holds hundreds of millions of observations; the price is
# ~2x the factor FLOPs per CG iteration (VPU work, traded for HBM — the
# jax.checkpoint idea applied by hand to the solver's hot loop).
# --------------------------------------------------------------------------


class _RematCtx(NamedTuple):
    """Everything a rematerialized pass needs besides the observation
    list: F-sized camera rows, P-sized point rows, and the per-point
    inverse blocks + gradient of the current build."""

    camrows: tuple
    X: Rows  # 3 x (P,)
    einv6: Rows  # 6 x (P,)
    d_P: Rows  # 3 x (P,)


def _remat_pass(body_fn, init, obs: SparseObs, chunk: int,
                axis_name=None):
    """fori_loop over dynamic column slices of the observation list —
    no padded (nch, C) copies of the (N,) arrays ever materialize (at
    hundreds of millions of observations the padded scan copies of the
    stored path would double the resident set). The tail chunk re-reads
    the last C columns with the already-processed prefix zero-weighted,
    so every reduction (all w-gated) stays exact. Under shard_map the
    zero init must be marked device-varying (the body folds in varying
    observation data) — ``axis_name`` routes it through ``_vary``."""
    if axis_name is not None:
        from .bundle_adjustment_chunked import _vary

        init = _vary(init, axis_name)
    n = obs.point_idx.shape[0]
    c = min(chunk, max(n, 1))
    nch = -(-n // c)
    arange = jnp.arange(c, dtype=jnp.int32)

    def body(k, acc):
        start = jnp.minimum(k * c, n - c)
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, start, c, axis=-1)
        pi_c, ci_c = sl(obs.point_idx), sl(obs.cam_idx)
        x_c, y_c = sl(obs.xy[0]), sl(obs.xy[1])
        fresh = (start + arange) >= k * c  # overlap guard (tail chunk)
        w_c = jnp.where(fresh, sl(obs.weights), 0)
        return body_fn(acc, (pi_c, ci_c, x_c, y_c, w_c))

    return jax.lax.fori_loop(0, nch, body, init)


def _residual_cols(camrows, X_t: Rows, pi, ci, xy0, xy1, w, f0, dist,
                   model):
    """Residual-only twin of _factor_cols (no Jacobian rows) for the
    rematerialized trial-error pass."""
    pm = camrows[0]
    pm_g = _rows_gather(pm, ci)
    X_g = _rows_gather(X_t, pi)
    p = pm_g[0] * X_g[0] + pm_g[1] * X_g[1] + pm_g[2] * X_g[2] + pm_g[3]
    q = pm_g[4] * X_g[0] + pm_g[5] * X_g[1] + pm_g[6] * X_g[2] + pm_g[7]
    r = pm_g[8] * X_g[0] + pm_g[9] * X_g[1] + pm_g[10] * X_g[2] + pm_g[11]
    r = jnp.where(w > 0, r, jnp.ones_like(r))
    if dist is None:
        return p / r - xy0 / f0, q / r - xy1 / f0
    f_g = camrows[1][ci]
    u_g = _rows_gather(camrows[2], ci)
    dist_g = _rows_gather(_cols_rows(dist), ci)
    rp, rq = _distorted_residual(
        _chain_state(f_g, jnp.stack(u_g, -1)), p[None], q[None], r[None],
        jnp.stack([xy0, xy1], -1)[None], f0, jnp.stack(dist_g, -1), model,
    )
    return rp[0], rq[0]


def _trial_error_remat(cam_e: BAState, X_e: Rows, cam_w: BAState,
                       X_w: Rows, obs: SparseObs, f0, huber_delta, dist,
                       model, robust_kind, obs_chunk, axis_name=None):
    """Sum of weighted squared residuals at (cam_e, X_e) with the IRLS
    weights evaluated at (cam_w, X_w) — the chunked-core convention —
    without materializing any (N,) intermediate."""
    camrows_e = _cam_factor_rows(cam_e, f0)
    camrows_w = (_cam_factor_rows(cam_w, f0)
                 if huber_delta is not None else None)
    dt = obs.xy.dtype

    def body(acc, cols):
        pi_c, ci_c, x_c, y_c, w_c = cols
        rp, rq = _residual_cols(
            camrows_e, X_e, pi_c, ci_c, x_c, y_c, w_c, f0, dist, model
        )
        if huber_delta is not None:
            rpw, rqw = _residual_cols(
                camrows_w, X_w, pi_c, ci_c, x_c, y_c, w_c, f0, dist, model
            )
            mag = jnp.sqrt(rpw**2 + rqw**2)
            w_c = w_c * robust_weight(mag, huber_delta, robust_kind)
        return acc + jnp.sum(w_c * (rp**2 + rq**2))

    e = _remat_pass(body, jnp.zeros((), dt), obs, obs_chunk, axis_name)
    return _psum(e, axis_name)


def _build_sparse_system_remat(cam, X, obs, free, f0, c, huber_delta,
                               dist, model, robust_kind, obs_chunk,
                               axis_name=None):
    """Two rematerialized passes replace the stored-factor build: pass 1
    accumulates the point-side blocks/gradient/error (einv needs the
    complete matE), pass 2 the camera-side blocks, SCHUR_JACOBI
    correction, and rhs. Camera segment sums run unsorted (the chunks
    are point-sorted), i.e. as scatter-adds into (F,)-sized rows."""
    npts, nf = X[0].shape[-1], cam.f.shape[0]
    dt = X[0].dtype
    camrows = _cam_factor_rows(cam, f0)

    def fac(cols):
        pi_c, ci_c, x_c, y_c, w_c = cols
        return _factor_cols(
            camrows, X, pi_c, ci_c, x_c, y_c, w_c, f0,
            huber_delta, dist, model, robust_kind,
        )

    def seg_p(rows_or_row, pi_c):
        if isinstance(rows_or_row, tuple):
            return tuple(
                jax.ops.segment_sum(r, pi_c, num_segments=npts,
                                    indices_are_sorted=True)
                for r in rows_or_row
            )
        return jax.ops.segment_sum(rows_or_row, pi_c, num_segments=npts,
                                   indices_are_sorted=True)

    def seg_c(rows_or_row, oh):
        # one-hot contraction per chunk (see _cam_sum_rows): scatter-
        # add to (F,)-sized rows is scalar-unit bound, ~70x slower
        if isinstance(rows_or_row, tuple):
            data = jnp.stack(rows_or_row, -1).astype(oh.dtype)
            fk = jnp.einsum("cf,ck->fk", oh, data, precision=HIGHEST)
            return tuple(fk[:, i] for i in range(len(rows_or_row)))
        return jnp.einsum(
            "cf,c->f", oh, rows_or_row.astype(oh.dtype), precision=HIGHEST
        )

    def add(a, b):
        return jax.tree.map(jnp.add, a, b)

    def pass1(acc, cols):
        pi_c = cols[0]
        a1, a2, b1, b2, rp, rq, w = fac(cols)
        w2 = 2.0 * w
        e_now, d_P, matE6, seen_w = acc
        e_now = e_now + jnp.sum(w * (rp**2 + rq**2))
        d_P = add(d_P, seg_p(
            tuple(w2 * (rp * a1i + rq * a2i) for a1i, a2i in zip(a1, a2)),
            pi_c))
        e_rows = (
            a1[0] * a1[0] + a2[0] * a2[0],
            a1[1] * a1[1] + a2[1] * a2[1],
            a1[2] * a1[2] + a2[2] * a2[2],
            a1[0] * a1[1] + a2[0] * a2[1],
            a1[0] * a1[2] + a2[0] * a2[2],
            a1[1] * a1[2] + a2[1] * a2[2],
        )
        matE6 = add(matE6, seg_p(tuple(w2 * e for e in e_rows), pi_c))
        seen_w = seen_w + seg_p(w, pi_c)
        return e_now, d_P, matE6, seen_w

    zp = lambda k: tuple(jnp.zeros((npts,), dt) for _ in range(k))
    e_now, d_P, matE6, seen_w = _remat_pass(
        pass1, (jnp.zeros((), dt), zp(3), zp(6), jnp.zeros((npts,), dt)),
        obs, obs_chunk, axis_name,
    )
    e_now = _psum(e_now, axis_name)

    seen = (seen_w > 0).astype(dt)
    unseen = 1.0 - seen
    matE6 = tuple(e + unseen if i < 3 else e for i, e in enumerate(matE6))
    matEc6 = tuple(e * (1.0 + c) if i < 3 else e
                   for i, e in enumerate(matE6))
    einv6 = _sym3_inv(matEc6)
    wp = _sym3_matvec(einv6, d_P)  # 3 x (P,)

    def pass2(acc, cols):
        pi_c, ci_c = cols[0], cols[1]
        a1, a2, b1, b2, rp, rq, w = fac(cols)
        w2 = 2.0 * w
        oh = _onehot(ci_c, nf, dt)
        d_F, b_f, matG, corr, seen_cw = acc
        d_F = add(d_F, seg_c(
            tuple(w2 * (rp * b1i + rq * b2i) for b1i, b2i in zip(b1, b2)),
            oh))
        wp_g = _rows_gather(wp, pi_c)
        r1 = w2 * _dot_rows(a1, wp_g)
        r2 = w2 * _dot_rows(a2, wp_g)
        b_f = add(b_f, seg_c(_axpy_rows(r1, b1, r2, b2), oh))
        einv_g = _rows_gather(einv6, pi_c)
        ea1 = _sym3_matvec(einv_g, a1)
        ea2 = _sym3_matvec(einv_g, a2)
        al11 = w2 * w2 * _dot_rows(a1, ea1)
        al12 = w2 * w2 * _dot_rows(a1, ea2)
        al22 = w2 * w2 * _dot_rows(a2, ea2)
        b1c = jnp.stack(b1, -1)  # (C, 9)
        b2c = jnp.stack(b2, -1)
        o11 = jnp.einsum("ni,nj->nij", b1c, b1c, precision=HIGHEST)
        o12 = jnp.einsum("ni,nj->nij", b1c, b2c, precision=HIGHEST)
        o22 = jnp.einsum("ni,nj->nij", b2c, b2c, precision=HIGHEST)
        seg9 = lambda v: jnp.einsum("cf,cij->fij", oh, v,
                                    precision=HIGHEST)
        matG = matG + seg9(w2[:, None, None] * (o11 + o22))
        corr = corr + seg9(
            al11[:, None, None] * o11
            + al12[:, None, None] * (o12 + jnp.swapaxes(o12, -1, -2))
            + al22[:, None, None] * o22
        )
        seen_cw = seen_cw + seg_c(w, oh)
        return d_F, b_f, matG, corr, seen_cw

    zf = lambda k: tuple(jnp.zeros((nf,), dt) for _ in range(k))
    init2 = (zf(9), zf(9), jnp.zeros((nf, 9, 9), dt),
             jnp.zeros((nf, 9, 9), dt), jnp.zeros((nf,), dt))
    d_F_rows, b_f_rows, matG, corr, seen_cw = _remat_pass(
        pass2, init2, obs, _cam_chunk(nf, obs_chunk, obs.n_obs), axis_name
    )
    d_F = _psum(_rows_to_flat(d_F_rows), axis_name) * free
    b_f = _psum(_rows_to_flat(b_f_rows), axis_name)
    matG = _psum(matG, axis_name)
    corr = _psum(corr, axis_name)
    seen_c = (_psum(seen_cw, axis_name) > 0).astype(dt)

    matGc = matG + c * matG * jnp.eye(9, dtype=dt)[None]
    m_blocks = matGc - corr
    free_b = free.reshape(nf, 9)
    m_blocks = m_blocks * (free_b[:, :, None] * free_b[:, None, :])
    fix = 1.0 - free_b
    m_blocks = m_blocks + jnp.eye(9, dtype=dt)[None] * (
        fix + (1.0 - seen_c)[:, None] * free_b
    )[:, :, None]
    m_inv = inv9_spd(m_blocks)

    rhs = (b_f - d_F) * free
    diag_g = jnp.diagonal(matG, axis1=-2, axis2=-1).reshape(-1)

    ctx = _RematCtx(camrows=camrows, X=X, einv6=einv6, d_P=d_P)
    return ctx, matGc, m_inv, rhs, d_F, diag_g, e_now, matE6, seen_c


def _f_point_rows_remat(vrows: Rows, ctx: _RematCtx, obs: SparseObs, f0,
                        huber_delta, dist, model, robust_kind, obs_chunk,
                        npts, axis_name=None):
    """Rematerialized F v: factors recomputed per chunk, point-sorted
    segment accumulation."""
    dt = ctx.X[0].dtype

    def body(acc, cols):
        pi_c, ci_c = cols[0], cols[1]
        a1, a2, b1, b2, _, _, w = _factor_cols(
            ctx.camrows, ctx.X, pi_c, ci_c, cols[2], cols[3], cols[4], f0,
            huber_delta, dist, model, robust_kind,
        )
        w2 = 2.0 * w
        v_g = _rows_gather(vrows, ci_c)
        u1 = w2 * _dot_rows(b1, v_g)
        u2 = w2 * _dot_rows(b2, v_g)
        t_rows = _axpy_rows(u1, a1, u2, a2)
        return tuple(
            ac + jax.ops.segment_sum(t, pi_c, num_segments=npts,
                                     indices_are_sorted=True)
            for ac, t in zip(acc, t_rows)
        )

    return _remat_pass(
        body, tuple(jnp.zeros((npts,), dt) for _ in range(3)), obs,
        obs_chunk, axis_name,
    )


def _ft_cam_rows_remat(w_p: Rows, ctx: _RematCtx, obs: SparseObs, f0,
                       huber_delta, dist, model, robust_kind, obs_chunk,
                       nf, axis_name=None):
    """Rematerialized F^T (point rows): factors recomputed per chunk,
    unsorted camera scatter-add accumulation."""
    dt = ctx.X[0].dtype

    def body(acc, cols):
        pi_c, ci_c = cols[0], cols[1]
        a1, a2, b1, b2, _, _, w = _factor_cols(
            ctx.camrows, ctx.X, pi_c, ci_c, cols[2], cols[3], cols[4], f0,
            huber_delta, dist, model, robust_kind,
        )
        w2 = 2.0 * w
        w_g = _rows_gather(w_p, pi_c)
        r1 = w2 * _dot_rows(a1, w_g)
        r2 = w2 * _dot_rows(a2, w_g)
        y = jnp.stack(_axpy_rows(r1, b1, r2, b2), -1).astype(dt)  # (C, 9)
        oh = _onehot(ci_c, nf, dt)
        return acc + jnp.einsum("cf,ck->fk", oh, y, precision=HIGHEST)

    acc = _remat_pass(
        body, jnp.zeros((nf, 9), dt), obs,
        _cam_chunk(nf, obs_chunk, obs.n_obs), axis_name,
    )
    return tuple(acc[:, i] for i in range(9))


def _schur_matvec_remat(v, ctx: _RematCtx, matGc, obs, free, seen_c, f0,
                        huber_delta, dist, model, robust_kind, obs_chunk,
                        axis_name=None):
    """S v for the damped, gauge-projected Schur complement with
    rematerialized factors — two chunk passes per matvec (point side,
    then camera side), O(chunk) transients."""
    nf = matGc.shape[0]
    npts = ctx.X[0].shape[-1]
    vm = (v * free).reshape(nf, 9)
    s_p = _f_point_rows_remat(
        _cols_rows(vm), ctx, obs, f0, huber_delta, dist, model,
        robust_kind, obs_chunk, npts, axis_name,
    )
    w_p = _sym3_matvec(ctx.einv6, s_p)
    fe_fv = _psum(
        jnp.stack(
            _ft_cam_rows_remat(w_p, ctx, obs, f0, huber_delta, dist,
                               model, robust_kind, obs_chunk, nf,
                               axis_name), -1,
        ),
        axis_name,
    )  # (F, 9)
    gv = jnp.einsum("fij,fj->fi", matGc, vm, precision=HIGHEST)
    sv = ((gv + (1.0 - seen_c)[:, None] * vm - fe_fv).reshape(-1)) * free
    return sv + (1.0 - free) * v


def _f_point_rows(vrows: Rows, factors, pi, ci, npts, matvec_chunk=None):
    """F v as 3 point rows: per observation u = w2 (b . v_cam), summed
    into point segments as t = u1 a1 + u2 a2. ``matvec_chunk`` bounds
    the per-observation transients (the nine gathered v rows, the dots,
    the t rows) to O(chunk) by accumulating chunk-local segment sums —
    the same capacity lever as ``obs_chunk`` in the build, applied to
    the CG hot path. The unchunked path is one fused full-N graph (the
    fast default when the transients fit)."""
    a1, a2, b1, b2, w2, einv6, _ = factors
    dt = w2.dtype
    if matvec_chunk is None:
        v_g = _rows_gather(vrows, ci)  # 9 x (N,) — nine 1-D gathers
        u1 = w2 * _dot_rows(b1, v_g)
        u2 = w2 * _dot_rows(b2, v_g)
        t_rows = _axpy_rows(u1, a1, u2, a2)  # 3 x (N,) = F v rows
        return _seg_rows(t_rows, pi, npts)  # 3 x (P,)

    n = w2.shape[-1]
    chunk = min(matvec_chunk, max(n, 1))
    nch = -(-n // chunk)
    # padded w2 is 0, so the npts-1 tail segment ids are inert (and keep
    # the per-chunk ids sorted: every real id is < npts)
    pi_pad = jnp.pad(pi, (0, nch * chunk - n),
                     constant_values=npts - 1).reshape(nch, chunk)
    ci_pad = jnp.pad(ci, (0, nch * chunk - n)).reshape(nch, chunk)

    def prep(rows):
        return jax.tree.map(lambda a: _prep_chunks(a, chunk, nch), rows)

    def body(acc, cols):
        a1c, a2c, b1c, b2c, w2c, pic, cic = cols
        v_g = _rows_gather(vrows, cic)
        u1 = w2c * _dot_rows(b1c, v_g)
        u2 = w2c * _dot_rows(b2c, v_g)
        t_rows = _axpy_rows(u1, a1c, u2, a2c)
        return tuple(
            ac + jax.ops.segment_sum(t, pic, num_segments=npts,
                                     indices_are_sorted=True)
            for ac, t in zip(acc, t_rows)
        ), ()

    s_p, _ = jax.lax.scan(
        body, tuple(jnp.zeros((npts,), dt) for _ in range(3)),
        (prep(a1), prep(a2), prep(b1), prep(b2), prep(w2), pi_pad, ci_pad),
    )
    return s_p


def _ft_cam_rows(w_p: Rows, factors, pi, ci, nf, obs_chunk,
                 matvec_chunk=None, axis_name=None):
    """F^T (Einv-weighted point rows) as nine camera rows: per
    observation r = w2 (a . w_point), summed into camera one-hot
    contractions (:func:`_cam_sum_rows`) — no camera sort. The
    ``matvec_chunk`` twin bounds the full-N transients (the gathered
    w rows, dots, y rows) by computing y inside the chunk loop."""
    a1, a2, b1, b2, w2, _, _ = factors
    dt = w2.dtype
    if matvec_chunk is None:
        w_g = _rows_gather(w_p, pi)
        r1 = w2 * _dot_rows(a1, w_g)
        r2 = w2 * _dot_rows(a2, w_g)
        return _cam_sum_rows(
            _axpy_rows(r1, b1, r2, b2), ci, nf, obs_chunk, axis_name
        )

    n = w2.shape[-1]
    chunk = _cam_chunk(nf, matvec_chunk, n)
    nch = -(-n // chunk)
    arange = jnp.arange(chunk, dtype=jnp.int32)

    def body(kk, acc):
        start = jnp.minimum(kk * chunk, n - chunk)
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, start, chunk, axis=-1)
        fresh = (start + arange) >= kk * chunk
        a1g = tuple(sl(r) for r in a1)
        a2g = tuple(sl(r) for r in a2)
        b1g = tuple(sl(r) for r in b1)
        b2g = tuple(sl(r) for r in b2)
        w_g = _rows_gather(w_p, sl(pi))
        w2c = jnp.where(fresh, sl(w2), 0)
        r1 = w2c * _dot_rows(a1g, w_g)
        r2 = w2c * _dot_rows(a2g, w_g)
        y = jnp.stack(_axpy_rows(r1, b1g, r2, b2g), -1).astype(dt)  # (C, 9)
        oh = _onehot(sl(ci), nf, dt)
        return acc + jnp.einsum("cf,ck->fk", oh, y, precision=HIGHEST)

    init = jnp.zeros((nf, 9), dt)
    if axis_name is not None:
        from .bundle_adjustment_chunked import _vary

        init = _vary(init, axis_name)
    acc = jax.lax.fori_loop(0, nch, body, init)
    return tuple(acc[:, i] for i in range(9))


def _schur_matvec(v, factors, matGc, obs, free, seen_c,
                  axis_name=None, matvec_chunk=None, obs_chunk=1 << 16):
    """S v for the damped, gauge-projected Schur complement — matrix-free,
    O(n_obs). v is (9F,). Under sharding only the F^T Einv F correction
    psums (one (9F,) vector per CG iteration — the entire cross-device
    traffic of a camera step); the Gc v product uses the already-reduced
    camera blocks, replicated. ``matvec_chunk`` bounds the full-N
    transients (see ``_f_point_rows``)."""
    einv6 = factors[5]
    nf = matGc.shape[0]
    vm = (v * free).reshape(nf, 9)
    pi, ci = obs.point_idx, obs.cam_idx
    s_p = _f_point_rows(_cols_rows(vm), factors, pi, ci,
                        einv6[0].shape[-1], matvec_chunk)
    w_p = _sym3_matvec(einv6, s_p)
    fe_fv = _psum(
        jnp.stack(
            _ft_cam_rows(w_p, factors, pi, ci, nf, obs_chunk,
                         matvec_chunk, axis_name), -1,
        ),
        axis_name,
    )  # (F, 9)
    gv = jnp.einsum("fij,fj->fi", matGc, vm, precision=HIGHEST)
    sv = ((gv + (1.0 - seen_c)[:, None] * vm - fe_fv).reshape(-1)) * free
    return sv + (1.0 - free) * v  # identity on gauge-fixed coords


def _pcg(matvec, precond, b, tol, max_iter, dt, x0=None):
    """Preconditioned conjugate gradients with relative-residual stop.
    All reduction scalars at HIGHEST precision. ``x0`` warm-starts the
    solve (one extra matvec to form the true initial residual); the
    stopping test stays relative to ||b||, so a good warm start simply
    exits in fewer iterations."""
    b_norm2 = jnp.vdot(b, b, precision=HIGHEST)
    tol2 = (tol * tol) * jnp.maximum(b_norm2, jnp.asarray(1e-30, dt))

    if x0 is None:
        x0 = jnp.zeros_like(b)
        r0 = b
    else:
        r0 = b - matvec(x0)
    z0 = precond(r0)

    def cond(carry):
        _, r, _, _, k, rr = carry
        return (rr > tol2) & (k < max_iter)

    def body(carry):
        x, r, z, p, k, _ = carry
        ap = matvec(p)
        pap = jnp.vdot(p, ap, precision=HIGHEST)
        rz = jnp.vdot(r, z, precision=HIGHEST)
        alpha = rz / jnp.where(pap > 0, pap, 1.0)
        alpha = jnp.where(pap > 0, alpha, 0.0)
        x1 = x + alpha * p
        r1 = r - alpha * ap
        z1 = precond(r1)
        rz1 = jnp.vdot(r1, z1, precision=HIGHEST)
        beta = rz1 / jnp.where(rz != 0, rz, 1.0)
        p1 = z1 + beta * p
        rr1 = jnp.vdot(r1, r1, precision=HIGHEST)
        return x1, r1, z1, p1, k + 1, rr1

    rr0 = jnp.vdot(r0, r0, precision=HIGHEST)
    x, _, _, _, n_iter, _ = jax.lax.while_loop(
        cond, body, (x0, r0, z0, z0, jnp.asarray(0), rr0)
    )
    return x, n_iter


def lm_optimize_sparse(
    obs: SparseObs,
    state0: BAState,
    free: jax.Array,
    f0: float,
    config: LMConfig,
    cg_tol: float = 1e-2,
    cg_max_iter: int = 100,
    obs_chunk: int = 1 << 16,
    init_c: jax.Array | None = None,
    init_nu: jax.Array | None = None,
    dist: jax.Array | None = None,
    axis_name: str | None = None,
    factor_dtype: str | None = None,
    matvec_chunk: int | None = None,
    factor_mode: str = "stored",
):
    """Observation-list LM with the dense core's exact protocol
    (reference ``bundle_adjustment.py:77-195``), the camera step solved
    by SCHUR_JACOBI-preconditioned CG. Returns
    (state, error, c, nu, n_iter, total_solver_retries, cg_iters_total).

    With ``axis_name`` set (inside shard_map over a point-partitioned
    observation list; see ``parallel/sharded_ba_sparse.py``) the camera-
    side quantities psum across devices; per CG iteration the entire
    cross-device traffic is one (9F,) psum.

    ``factor_dtype`` (e.g. ``"bfloat16"``) stores the 24 per-observation
    Jacobian factor rows — the dominant per-observation residency, live
    across the whole CG solve — in a narrow dtype, roughly halving the
    single-chip observation capacity. Numerics: the CG *operator* and
    the built system carry the factor rounding (~4e-3 relative for
    bf16) while residuals, the rhs reductions, accept decisions, and
    all P-/F-sized state stay full precision, so each LM step solves a
    slightly perturbed Newton system but acceptance/convergence are
    judged exactly — the same inexactness class as a loose ``cg_tol``
    (cf. the north star's bf16-Y result, BASELINE.md: bf16 *stored*
    factors are benign; bf16 passes inside the factor *computation* are
    not).

    ``factor_mode="recompute"`` never stores the factor rows at all:
    every pass rematerializes them chunk-by-chunk (see the
    ``_RematCtx`` block above). Per-observation residency falls to the
    ~20 B of the observation list itself — hundreds of millions of
    observations on one chip — at ~2x factor FLOPs per CG iteration.
    Results match the stored path to CG tolerance (the operator is the
    same map evaluated in a different summation order). In this mode
    ``matvec_chunk`` sets the chunk of the matvec/back-substitution
    passes only (default ``obs_chunk``) — those passes carry ~30 (C,)
    rows of transients vs the build's (C, 9, 9) outer products, so a
    4-16x larger matvec chunk amortizes loop overhead safely.
    """
    dt = obs.xy.dtype
    remat = factor_mode == "recompute"
    if factor_mode not in ("stored", "recompute"):
        raise ValueError(f"unknown factor_mode: {factor_mode!r}")
    f_dt = jnp.dtype(factor_dtype) if factor_dtype is not None else None
    npts, nf = state0.X.shape[0], state0.f.shape[0]
    model = resolve_distortion_model(dist, config.distortion_model)
    obs_chunk = min(obs_chunk, max(obs.n_obs, 1))

    # camera-side reductions are one-hot contractions over the
    # point-sorted order in BOTH modes — no camera sort exists anymore

    nielsen = config.damping == "nielsen"
    robust_cfg = resolve_robust(config.robust)
    huber_delta = config.huber_delta if robust_cfg is not None else None
    robust_kind = robust_cfg or "huber"

    def split(state):
        # points ride the loop as three (P,) coordinate rows
        return (state._replace(X=jnp.zeros((0, 3), dt)),
                _cols_rows(state.X))

    def weights_at(cam, X):
        if huber_delta is None:
            return obs.weights
        rp, rq = _residuals_t(cam, X, obs, obs.weights, f0, dist, model,
                              obs_chunk)
        mag = jnp.sqrt(rp**2 + rq**2)
        return obs.weights * robust_weight(mag, huber_delta, robust_kind)

    def error_of(cam, X):
        if remat:
            return _trial_error_remat(
                cam, X, cam, X, obs, f0, huber_delta, dist, model,
                robust_kind, obs_chunk, axis_name,
            )
        return _trial_error(cam, X, obs, weights_at(cam, X), f0, dist,
                            model, axis_name, obs_chunk)

    cam0, X0 = split(state0)
    if remat or huber_delta is not None:
        e0 = error_of(cam0, X0)
    else:
        e0 = _trial_error(cam0, X0, obs, obs.weights, f0, dist, model,
                          axis_name)

    # O(max_iter) scalar error curve — the chunked core's record_log
    # contract (scale-aware debug logging; full-state animation logs are
    # exactly what an O(n_obs) core exists to avoid)
    record = config.record_log
    log0 = (jnp.zeros((config.max_iter + 1,), dt).at[0].set(e0)
            if record else jnp.zeros((0,), dt))

    def inner(cam, X, e_prev, c, nu):
        def cond(carry):
            accepted, tries = carry[-3], carry[-2]
            return (~accepted) & (tries < config.max_inner_retries)

        def body(carry):
            c_cur, nu_cur, _, _, _, _, cg_tot, _, tries, delta_prev = carry
            if remat:
                (factors, matGc, m_inv, rhs, d_F, diag_g, e_w, matE,
                 seen_c) = _build_sparse_system_remat(
                    cam, X, obs, free, f0, c_cur, huber_delta, dist,
                    model, robust_kind, obs_chunk, axis_name,
                )
            else:
                (factors, matGc, m_inv, rhs, d_F, diag_g, e_w, matE,
                 seen_c) = _build_sparse_system(
                    cam, X, obs, free, f0, c_cur,
                    huber_delta, dist, model, robust_kind, obs_chunk,
                    axis_name, f_dt,
                )

            def mv(v):
                if remat:
                    # the matvec passes carry only ~30 (C,) rows of
                    # transients (no (C, 9, 9) outers like the build),
                    # so a larger chunk amortizes the loop overhead
                    return _schur_matvec_remat(
                        v, factors, matGc, obs, free, seen_c, f0,
                        huber_delta, dist, model, robust_kind,
                        matvec_chunk or obs_chunk, axis_name,
                    )
                return _schur_matvec(
                    v, factors, matGc, obs, free, seen_c,
                    axis_name, matvec_chunk, obs_chunk,
                )

            def pc(v):
                return (
                    jnp.einsum(
                        "fij,fj->fi", m_inv, v.reshape(nf, 9),
                        precision=HIGHEST,
                    ).reshape(-1)
                )

            # warm start across rejected retries: the re-solve has the
            # SAME rhs (only the damping c changed), so the previous
            # delta is one matvec away from a near-converged start; the
            # first try of each outer iteration starts cold (zeros)
            delta_xi, cg_iters = _pcg(
                mv, pc, rhs, cg_tol, cg_max_iter, dt, x0=delta_prev
            )
            delta_xi = delta_xi * free

            # back-substitute points: delta_X = -Einv (F delta + d_P)
            if remat:
                einv6, d_P = factors.einv6, factors.d_P
                f_dxi = _f_point_rows_remat(
                    _cols_rows(delta_xi.reshape(nf, 9)), factors, obs, f0,
                    huber_delta, dist, model, robust_kind,
                    matvec_chunk or obs_chunk, npts, axis_name,
                )
            else:
                einv6, d_P = factors[5], factors[6]
                f_dxi = _f_point_rows(
                    _cols_rows(delta_xi.reshape(nf, 9)), factors,
                    obs.point_idx, obs.cam_idx, npts, matvec_chunk,
                )
            mw = _sym3_matvec(einv6, tuple(f + d for f, d in
                                           zip(f_dxi, d_P)))
            delta_X = tuple(-m for m in mw)  # 3 x (P,)
            X_new = tuple(x + d for x, d in zip(X, delta_X))

            trial_cam = _apply_update(cam, delta_xi, jnp.zeros((0, 3), dt))
            if remat:
                e_trial = _trial_error_remat(
                    trial_cam, X_new, cam, X, obs, f0, huber_delta, dist,
                    model, robust_kind, obs_chunk, axis_name,
                )
            else:
                w_cur = weights_at(cam, X)
                e_trial = _trial_error(trial_cam, X_new, obs, w_cur, f0,
                                       dist, model, axis_name, obs_chunk)
            e_base = e_w if huber_delta is not None else e_prev
            accepted = e_trial <= e_base
            if nielsen:
                diag_e = matE[:3]  # undamped point-block diagonal rows
                dDd = (
                    _psum(sum(jnp.sum(dx * de * dx) for dx, de in
                              zip(delta_X, diag_e)), axis_name)
                    + jnp.sum(delta_xi * diag_g * delta_xi)
                )
                g_d = (
                    _psum(sum(jnp.sum(dp * dx) for dp, dx in
                              zip(d_P, delta_X)), axis_name)
                    + jnp.sum(d_F * delta_xi)
                )
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
            return (c_next, nu_next, e_trial, e_base, trial_cam, X_new,
                    cg_tot + cg_iters, accepted, tries + 1, delta_xi)

        dummy_cam = jax.tree.map(jnp.zeros_like, cam)
        (c_out, nu_out, e_new, e_base_out, trial_cam, X_new, cg_tot,
         accepted, tries, _) = jax.lax.while_loop(
            cond, body,
            (c, nu, jnp.asarray(jnp.inf, dt), e_prev, dummy_cam,
             jax.tree.map(jnp.zeros_like, X), jnp.asarray(0),
             jnp.asarray(False), 0, jnp.zeros((9 * nf,), dt)),
        )
        trial_cam = jax.tree.map(
            lambda a, b: jnp.where(accepted, a, b), trial_cam, cam
        )
        X_new = jax.tree.map(lambda a, b: jnp.where(accepted, a, b),
                             X_new, X)
        e_new = jnp.where(accepted, e_new, e_base_out)
        return c_out, nu_out, e_new, e_base_out, trial_cam, X_new, cg_tot, tries

    def cond(carry):
        count, done = carry[5], carry[6]
        return (~done) & (count < config.max_iter)

    def body(carry):
        cam, X, e_prev, c, nu, count, _, retries, cg_tot, log = carry
        (c_new, nu_new, e_new, e_base, cam_new, X_new, cg_in, tries) = inner(
            cam, X, e_prev, c, nu
        )
        done = jnp.abs(e_new - e_base) <= config.delta_tol
        c_out = c_new if nielsen else c_new / config.divisor
        if record:
            log = log.at[count + 1].set(e_new)
        return (cam_new, X_new, e_new, c_out, nu_new, count + 1, done,
                retries + tries, cg_tot + cg_in, log)

    c0 = (jnp.asarray(config.init_damping, dt) if init_c is None
          else jnp.asarray(init_c, dt))
    nu0 = jnp.asarray(2.0, dt) if init_nu is None else jnp.asarray(init_nu, dt)
    (cam_f, X_f, e_f, c_f, nu_f, n_iter, done_f, n_retries, cg_total,
     log_f) = jax.lax.while_loop(
        cond, body,
        (cam0, X0, e0, c0, nu0, jnp.asarray(0), jnp.asarray(False),
         jnp.asarray(0), jnp.asarray(0), log0),
    )
    return (cam_f._replace(X=jnp.stack(X_f, -1)), e_f, c_f, nu_f, n_iter,
            n_retries, cg_total, log_f if record else None, done_f)


def fit_distortion_sparse(
    state: BAState, obs: SparseObs, f0: float, shared: bool = False,
    huber_delta: float | None = None, dist=None,
    model: str | None = None, robust_kind: str = "huber",
    axis_name: str | None = None, obs_chunk: int = 1 << 16,
) -> jax.Array:
    """Closed-form distortion refit on the observation list: the dense
    core's per-camera normal-equation accumulands (every family) are
    per-observation quantities under the virtual-camera trick, then one
    camera-segment-sum (psum-reduced under sharding) replaces the dense
    per-point reduction."""
    if model is None:
        model = resolve_distortion_model(dist, "auto")
    ci = obs.cam_idx
    nf = state.f.shape[0]
    dt = obs.xy.dtype
    cam = state._replace(X=jnp.zeros((0, 3), dt))
    X_r = _cols_rows(state.X) if not isinstance(state.X, tuple) else state.X
    _, _, p, q, r = _pqr_t(cam, X_r, obs, f0)
    w = obs.weights
    f_g = cam.f[ci]
    u_g = _rows_gather(_cols_rows(cam.u), ci)  # 2 x (N,)
    if huber_delta is not None:
        rp, rq = _residuals_t(cam, X_r, obs, w, f0, dist, model, obs_chunk)
        mag = jnp.sqrt(rp**2 + rq**2)
        w = w * robust_weight(mag, huber_delta, robust_kind)

    def seg_terms(term_fn, cur):
        """Chunk-scanned per-camera accumulation of the closed-form
        normal-equation terms: nothing (N, k)-shaped materializes.
        ``term_fn(state, p, q, r, x, vis, dist_rows)`` evaluates the
        dense core's per-observation terms on a (1, C) chunk."""
        cur_g = _rows_gather(_cols_rows(cur), ci)  # k x (N,)

        def body(acc, cols):
            p_c, q_c, r_c, x_c, y_c, w_c, f_c, u_c, d_c, ci_c = cols
            t = term_fn(
                _chain_state(f_c, jnp.stack(u_c, -1)), p_c[None],
                q_c[None], r_c[None], jnp.stack([x_c, y_c], -1)[None],
                w_c[None], jnp.stack(d_c, -1),
            )
            # one-hot contraction (see _cam_sum_rows): t is
            # (C, ...) per-observation terms -> (F, ...) camera sums
            oh = _onehot(ci_c, nf, t.dtype)
            tf = jnp.einsum(
                "cf,cx->fx", oh, t.reshape(t.shape[0], -1),
                precision=HIGHEST,
            ).reshape((nf,) + t.shape[1:])
            return acc + tf, ()

        n = p.shape[0]
        chunk = min(obs_chunk, max(n, 1))
        nch = -(-n // chunk)
        ci_pad = jnp.pad(ci, (0, nch * chunk - n),
                         constant_values=nf - 1).reshape(nch, chunk)
        probe = term_fn(
            _chain_state(f_g[:1], jnp.stack([u_g[0][:1], u_g[1][:1]], -1)),
            p[None, :1], q[None, :1], r[None, :1],
            jnp.stack([obs.xy[0][:1], obs.xy[1][:1]], -1)[None], w[None, :1],
            jnp.stack([d[:1] for d in cur_g], -1),
        )
        from .bundle_adjustment_chunked import _vary

        acc0 = _vary(jnp.zeros((nf,) + probe.shape[1:], dt), axis_name)
        acc, _ = jax.lax.scan(
            body, acc0,
            jax.tree.map(
                lambda a: _prep_chunks(a, chunk, nch),
                (p, q, r, obs.xy[0], obs.xy[1], w, f_g, u_g, cur_g),
            ) + (ci_pad,),
        )
        return _psum(acc, axis_name)

    if model == "full_opencv":
        cur = dist if dist is not None else jnp.zeros((nf, 8), dt)
        for _ in range(FULL_OPENCV_ALTERNATIONS):
            for round_ in ("num", "den"):
                def term_fn(st, pc, qc, rc, xc, vc, dc, _r=round_):
                    return _full_opencv_lsq_terms(
                        st, pc, qc, rc, xc, vc, f0, dc, _r
                    )

                cur = _solve_full_opencv_round(
                    seg_terms(term_fn, cur), cur, round_, shared
                )
        return cur
    if model == "fov":
        cur = (dist if dist is not None else jnp.full((nf, 1), 0.5, dt))
        for _ in range(_FOV_GN_STEPS):
            def term_fn(st, pc, qc, rc, xc, vc, dc):
                return _fov_gn_terms(st, pc, qc, rc, xc, vc, f0, dc)

            cur = _solve_fov_step(seg_terms(term_fn, cur), cur, shared)
        return cur

    def term_fn(st, pc, qc, rc, xc, vc, dc):
        return _distortion_lsq_terms(st, pc, qc, rc, xc, vc, f0, model)

    cur0 = jnp.zeros((nf, max(distortion_nterms(model), 1)), dt) \
        if dist is None else dist
    return _solve_distortion_lsq(seg_terms(term_fn, cur0), shared)


@partial(jax.jit, static_argnames=(
    "f0", "axis", "config", "cg_tol", "cg_max_iter", "obs_chunk",
    "factor_dtype", "matvec_chunk", "factor_mode",
))
def bundle_adjust_sparse(
    obs: SparseObs,
    init_X: jax.Array,
    init_K: jax.Array,
    init_R: jax.Array,
    init_t: jax.Array,
    f0: float = 1.0,
    axis: str = "x-right_z-forward",
    config: LMConfig = LMConfig(),
    cg_tol: float = 1e-2,
    cg_max_iter: int = 100,
    obs_chunk: int = 1 << 16,
    init_c: jax.Array | None = None,
    init_nu: jax.Array | None = None,
    distortion: jax.Array | None = None,
    factor_dtype: str | None = None,
    matvec_chunk: int | None = None,
    factor_mode: str = "stored",
) -> BAResult:
    """Bundle adjustment over an observation list (O(n_obs) memory) —
    the core for BAL-class sparsity (0.1-1% fill), where the dense
    (P, F) mask layout of the other cores cannot hold the problem.
    Semantics (LM protocol, gauge, distortion alternation, robust
    losses, resume via ``init_c``/``init_nu``) match ``bundle_adjust``;
    the camera step is solved matrix-free by preconditioned CG instead
    of a dense Cholesky, so results agree with the dense core to the
    CG tolerance (tighten ``cg_tol`` for exact parity checks).
    ``factor_dtype="bfloat16"`` stores the per-observation Jacobian
    factor rows narrow — ~1.6x single-chip observation capacity at the
    cost of an O(1e-3)-perturbed (but exactly-judged) LM step; see
    ``lm_optimize_sparse``."""
    dt = obs.xy.dtype
    nf = init_K.shape[0]
    X0, R0, t0, info = normalize_gauge(init_X, init_R, init_t, axis)
    f_in, u_in = intrinsics_from_K(init_K, f0)
    state0 = BAState(X=X0, f=f_in, u=u_in, t=t0, R=R0)
    free = gauge_mask(nf, axis, dt)

    dist = None if distortion is None else jnp.asarray(distortion, dt)
    model = resolve_distortion_model(dist, config.distortion_model)
    if config.distortion_rounds > 0 and dist is None:
        dist = default_distortion(model, nf, dt)

    robust_cfg = resolve_robust(config.robust)
    n_total = jnp.asarray(0)
    c_seg, nu_seg = init_c, init_nu
    for _ in range(config.distortion_rounds):
        dist = fit_distortion_sparse(
            state0, obs, f0, shared=config.distortion_shared,
            huber_delta=(config.huber_delta if robust_cfg is not None
                         else None),
            dist=dist, model=model, robust_kind=robust_cfg or "huber",
            obs_chunk=obs_chunk,
        )
        seg_cfg = dataclasses.replace(config, record_log=False)
        state0, _, c_seg, nu_seg, n_seg, _, _, _, _ = lm_optimize_sparse(
            obs, state0, free, f0, seg_cfg, cg_tol, cg_max_iter, obs_chunk,
            init_c=c_seg, init_nu=nu_seg, dist=dist,
            factor_dtype=factor_dtype, matvec_chunk=matvec_chunk,
            factor_mode=factor_mode,
        )
        n_total = n_total + n_seg

    (final, e, c_f, nu_f, n_iter, n_retries, cg_total,
     scalar_log, done_f) = lm_optimize_sparse(
        obs, state0, free, f0, config, cg_tol, cg_max_iter, obs_chunk,
        init_c=c_seg, init_nu=nu_seg, dist=dist, factor_dtype=factor_dtype,
        matvec_chunk=matvec_chunk, factor_mode=factor_mode,
    )
    Xg, Rg, tg = restore_gauge(info, final.X, final.R, final.t)
    log = {"n_solver_retries": n_retries, "c": c_f, "nu": nu_f,
           "cg_iters_total": cg_total,
           # the |dE| <= delta_tol / never-accepted stop flag: segmented
           # drivers (segment_iters == max_iter per call) need it because
           # n_iter == max_iter cannot distinguish "converged on the
           # segment's last iteration" from "still descending"
           "converged": done_f}
    if scalar_log is not None:
        log["reprojection_error"] = scalar_log
    return BAResult(
        X=Xg, K=build_K(final.f, final.u, f0), R=Rg, t=tg, error=e,
        n_iter=n_iter + n_total,
        log=log,
        distortion=dist,
    )
