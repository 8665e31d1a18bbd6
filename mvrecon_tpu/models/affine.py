"""Affine camera self-calibration (orthographic / symmetric-affine /
paraperspective metric upgrades).

Capability parity: reference ``lib/affine_camera_calibration.py`` — same
math, accelerator-first shape discipline:

- observations are a dense (F, P, 2) array (the reference passes a Python
  list of (P, 2) arrays, ``affine_camera_calibration.py:224-240``);
- the O(F * 81) scalar ``B_cal`` loops (``:23-38, :75-115, :156-202``)
  become one fourth-moment quadratic form ``sum_f V^T C V`` (see
  ``ops/moments.py``) — each camera model differs only in the tiny (3, 3)
  coefficient matrix C;
- ``np.linalg.eig`` of the (symmetric) 6x6 B (``:120, :207``) becomes
  ``eigh`` (min eigenvalue = index 0);
- rotation recovery (``:272-341``) is fully batched einsum.

All functions are jittable and vmap over a leading scene axis.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import HIGHEST
from ..ops.linalg import min_eigvec_sym, orthonormalize
from ..ops.moments import fourth_moment_matrix, sym_expand, sym_reduce


def observation_matrix(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Centered observation matrix W (2F, P) with per-image centroids
    t (F, 2) (reference ``affine_camera_calibration.py:224-240``).

    Row layout matches the reference's ``np.hstack(data_list).T``:
    row 2i = x-coords of image i, row 2i+1 = y-coords of image i.
    """
    nf, npts, _ = x.shape
    t = x.mean(axis=1)  # (F, 2)
    centered = x - t[:, None, :]
    w = centered.transpose(0, 2, 1).reshape(2 * nf, npts)
    return w, t


def _outer_basis(u0: jax.Array, u1: jax.Array) -> jax.Array:
    """Per-image symmetric outer-product basis V (F, 3, 9): rows are
    flattened u0 u0^T, u1 u1^T, u0 u1^T + u1 u0^T."""
    s00 = jnp.einsum("fi,fj->fij", u0, u0)
    s11 = jnp.einsum("fi,fj->fij", u1, u1)
    s01 = jnp.einsum("fi,fj->fij", u0, u1)
    z = s01 + jnp.swapaxes(s01, -1, -2)
    nf = u0.shape[0]
    return jnp.stack([s00, s11, z], axis=1).reshape(nf, 3, 9)


def _coeff_orthographic(t: jax.Array, f: jax.Array | None, dtype) -> jax.Array:
    """C = diag(1, 1, 1/4): B_cal = sum S00 S00 + S11 S11 + (z/2)(z/2)
    (reference ``affine_camera_calibration.py:29-36``)."""
    nf = t.shape[0]
    c = jnp.diag(jnp.array([1.0, 1.0, 0.25], dtype=dtype))
    return jnp.broadcast_to(c, (nf, 3, 3))


def _coeff_symmetric(t: jax.Array, f: jax.Array | None, dtype) -> jax.Array:
    """Rank-1 C = w w^T with w = (a, -a, -c/2), a = tx ty,
    c = tx^2 - ty^2: the reference's 16-term loop
    (``affine_camera_calibration.py:83-113``) factors exactly into
    (a (S00 - S11) - c/2 (S01 + S10)) tensor itself."""
    a = t[:, 0] * t[:, 1]
    c = t[:, 0] ** 2 - t[:, 1] ** 2
    w = jnp.stack([a, -a, -0.5 * c], axis=-1)  # (F, 3)
    return jnp.einsum("fa,fb->fab", w, w)


def _coeff_paraperspective(t: jax.Array, f: jax.Array, dtype) -> jax.Array:
    """Paraperspective coefficient matrix in basis (S00, S11, S01+S10)
    with alpha = 1/(1 + tx^2/f^2), beta = 1/(1 + ty^2/f^2),
    gamma = tx ty / f^2 (reference ``affine_camera_calibration.py:156-202``):

        [[(g^2+1) a^2, (g^2-1) a b, -a g],
         [(g^2-1) a b, (g^2+1) b^2, -b g],
         [-a g,        -b g,         1  ]]
    """
    f2 = f**2
    alpha = 1.0 / (1.0 + t[:, 0] ** 2 / f2)
    beta = 1.0 / (1.0 + t[:, 1] ** 2 / f2)
    gamma = t[:, 0] * t[:, 1] / f2
    g2 = gamma**2
    one = jnp.ones_like(alpha)
    c = jnp.stack(
        [
            jnp.stack([(g2 + 1) * alpha**2, (g2 - 1) * alpha * beta, -alpha * gamma], axis=-1),
            jnp.stack([(g2 - 1) * alpha * beta, (g2 + 1) * beta**2, -beta * gamma], axis=-1),
            jnp.stack([-alpha * gamma, -beta * gamma, one], axis=-1),
        ],
        axis=-2,
    )
    return c


_COEFFS = {
    "orthographic": _coeff_orthographic,
    "symmetric": _coeff_symmetric,
    "paraperspective": _coeff_paraperspective,
}


def _zeta_beta_g(
    u0: jax.Array, u1: jax.Array, T: jax.Array, t: jax.Array
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Per-image zeta, beta, g for rotation recovery (reference
    ``affine_camera_calibration.py:272-309``), including its degenerate-case
    clamps: beta^2 < 0 -> 0; |t| ~ 0 -> beta = 0 and
    zeta^-2 = (Q0 + Q2)/2; zeta^-2 <= 0 -> 1e8."""
    nf = t.shape[0]
    dt = t.dtype

    # P (F, 3, 2): column 0 = (1, 1, 0), column 1 = (tx^2, ty^2, tx ty).
    col0 = jnp.broadcast_to(jnp.array([1.0, 1.0, 0.0], dtype=dt), (nf, 3))
    col1 = jnp.stack([t[:, 0] ** 2, t[:, 1] ** 2, t[:, 0] * t[:, 1]], axis=-1)
    P = jnp.stack([col0, col1], axis=-1)

    q0 = jnp.einsum("fi,ij,fj->f", u0, T, u0, precision=HIGHEST)
    q1 = jnp.einsum("fi,ij,fj->f", u0, T, u1, precision=HIGHEST)
    q2 = jnp.einsum("fi,ij,fj->f", u1, T, u1, precision=HIGHEST)
    Q = jnp.stack([q0, q1, q2], axis=-1)  # (F, 3)

    sol = jnp.einsum("fij,fj->fi", jnp.linalg.pinv(P), Q)  # (F, 2)
    zeta2_inv, beta2 = sol[:, 0], sol[:, 1]

    beta2 = jnp.where(beta2 < 0.0, 0.0, beta2)
    degenerate = (jnp.abs(t) < 1e-8).all(axis=1)
    beta2 = jnp.where(degenerate, 0.0, beta2)
    zeta2_inv = jnp.where(degenerate, (q0 + q2) / 2.0, zeta2_inv)
    zeta2_inv = jnp.where(zeta2_inv <= 0.0, 1e8, zeta2_inv)

    zeta = jnp.sqrt(1.0 / zeta2_inv)
    beta = jnp.sqrt(beta2)
    g = zeta[:, None] * t
    return zeta, beta, g


def _rotation_from_motion(
    M: jax.Array, u0: jax.Array, u1: jax.Array, T: jax.Array, t: jax.Array
) -> jax.Array:
    """Recover per-image rotations from the metric motion matrix
    (reference ``affine_camera_calibration.py:312-341``).

    Note: the reference's r3 normalizer uses image 0's ||g||^2 for *every*
    image (the ``[0]`` at ``affine_camera_calibration.py:325``); replicated
    here for output parity.
    """
    zeta, beta, g = _zeta_beta_g(u0, u1, T, t)

    m1 = M[0::2]  # (F, 3)
    m2 = M[1::2]
    mblk = M.reshape(-1, 2, 3)

    r3_denom = zeta[:, None] * jnp.cross(m1, m2) - beta[:, None] * jnp.einsum(
        "fa,fai->fi", g, mblk
    )
    g0_sq = jnp.sum(g[0] * g[0])
    r3_num = 1.0 + beta[:, None] ** 2 * g0_sq
    r3 = r3_denom / r3_num

    r1 = zeta[:, None] * m1 + (beta * g[:, 0])[:, None] * r3
    r2 = zeta[:, None] * m2 + (beta * g[:, 1])[:, None] * r3

    R = jnp.stack([r1, r2, r3], axis=-1)  # columns r1, r2, r3
    return orthonormalize(R)


def metric_upgrade_from_subspace(
    u_: jax.Array, t: jax.Array, model: str, f: jax.Array | None
) -> tuple[jax.Array, jax.Array]:
    """Metric upgrade + rotation recovery from the rank-3 left subspace.

    ``u_`` (2F, 3) spans W's leading left subspace (SVD columns or Gram
    eigenvectors — any orthonormal basis of the same span, the upgrade is
    covariant in it); ``t`` (F, 2) are the per-image centroids. Returns
    (A, R): the metric-upgrading factor (Cholesky of T, reference
    ``affine_camera_calibration.py:49,127,214``) and per-image rotations.
    Shared by the single-device path below and the point-sharded path
    (``parallel/sharded_affine.py``), where everything here is replicated
    O(F) work and only the shape rows are sharded.
    """
    u0, u1 = u_[0::2], u_[1::2]
    basis = _outer_basis(u0, u1)
    coeff = _COEFFS[model](t, f, u_.dtype)
    bcal = fourth_moment_matrix(basis, coeff)  # (9, 9)
    b6 = sym_reduce(bcal, 3)

    if model == "orthographic":
        rhs = jnp.array([1.0, 1.0, 1.0, 0.0, 0.0, 0.0], dtype=u_.dtype)
        tau = jnp.linalg.solve(b6, rhs)
    else:
        _, tau = min_eigvec_sym(b6)

    T = sym_expand(tau, 3)
    T = jnp.where(jnp.linalg.det(T) < 0, -T, T)

    A = jnp.linalg.cholesky(T)
    M = u_ @ A
    R = _rotation_from_motion(M, u0, u1, T, t)
    return A, R


@partial(jax.jit, static_argnames=("model", "canonical_signs"))
def affine_self_calibration(
    x: jax.Array,
    model: str = "paraperspective",
    f: jax.Array | None = None,
    canonical_signs: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Affine self-calibration of observations x (F, P, 2).

    Returns (S, R): shape S (P, 3) and per-image rotations R (F, 3, 3)
    (reference entry points ``affine_camera_calibration.py:7,59,137``).
    ``f`` (F,) focal lengths are required for the paraperspective model.

    ``canonical_signs``: the reconstruction branch depends on the SVD's
    per-column sign choice (flipping subspace column k flips shape axis k
    and can mirror the solution). Default keeps the backend's SVD signs
    (LAPACK on CPU-x64 = reference oracle parity); True pins each column
    so the first point's shape coordinate is non-negative — the
    data-deterministic convention the point-sharded path
    (``parallel/sharded_affine.py``) uses, enabling exact cross-path
    comparison.
    """
    if model not in _COEFFS:
        raise ValueError(f"unknown affine model: {model}")
    if model == "paraperspective" and f is None:
        raise ValueError("paraperspective model requires focal lengths f")

    w, t = observation_matrix(x)
    u, sigma, vt = jnp.linalg.svd(w, full_matrices=False)
    u_ = u[:, :3]
    vt3 = vt[:3]
    if canonical_signs:
        d = jnp.where(vt3[:, 0] < 0, -1.0, 1.0).astype(x.dtype)
        u_ = u_ * d[None, :]
        vt3 = vt3 * d[:, None]

    if f is not None:
        f = jnp.asarray(f, dtype=x.dtype)
    A, R = metric_upgrade_from_subspace(u_, t, model, f)
    S = jnp.linalg.inv(A) @ (sigma[:3, None] * vt3)
    return S.T, R


@partial(jax.jit, static_argnames=("model",))
def affine_self_calibration_full(
    x: jax.Array, model: str = "paraperspective", f: jax.Array | None = None
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Like ``affine_self_calibration`` but additionally returns an
    in-graph ``ok`` flag. The reference fails by *crashing* inside
    ``np.linalg.cholesky`` when the metric matrix T is not positive
    definite under noise (``affine_camera_calibration.py:49,127,214``);
    on the device that failure mode is NaN propagation, surfaced here as a status
    flag (SURVEY.md §5, sanitizers row)."""
    s, r = affine_self_calibration(x, model=model, f=f)
    ok = jnp.isfinite(s).all() & jnp.isfinite(r).all()
    return s, r, ok


def orthographic_self_calibration(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Orthographic metric upgrade (reference
    ``affine_camera_calibration.py:7-56``)."""
    return affine_self_calibration(x, model="orthographic")


def symmetric_affine_self_calibration(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Symmetric-affine metric upgrade (reference
    ``affine_camera_calibration.py:59-134``)."""
    return affine_self_calibration(x, model="symmetric")


def paraperspective_self_calibration(
    x: jax.Array, f: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Paraperspective metric upgrade (reference
    ``affine_camera_calibration.py:137-221``)."""
    return affine_self_calibration(x, model="paraperspective", f=f)
