"""Fourth-moment quadratic forms — the matmul formulation of the reference's
scalar metric-constraint loops.

The reference builds 3^4 / 4^4 constraint tensors ``B_cal`` / ``A_cal`` with
O(F * 81) / O(F * 256) Python ``itertools.product`` loops
(``affine_camera_calibration.py:23-38,75-115,156-202``;
``perspective_camera_calibration.py:239-272``). Every one of those loops is
algebraically a sum of tensor products of per-image *outer-product basis
vectors*:

    B_cal = sum_f  V[f]^T  C[f]  V[f]        (in the flattened n^2 space)

where row ``a`` of ``V[f]`` is a flattened symmetric combination of outer
products of the motion rows (e.g. ``u0 u0^T``, ``u1 u1^T``,
``u0 u1^T + u1 u0^T``) and ``C[f]`` is a tiny per-image coefficient matrix
determined by the camera model. That turns the hot scalar loop into one
einsum/matmul — exactly what matrix units want, and trivially vmappable over
scenes.

``sym_reduce`` / ``sym_expand`` implement the reference's packing of the
symmetric 4-tensor into the reduced (6x6 / 10x10) eigenproblem
(``affine_camera_calibration.py:243-269``;
``perspective_camera_calibration.py:274-307``) with the same sqrt(2)
normalization and pair orderings.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..config import HIGHEST


def fourth_moment_matrix(v: jax.Array, c: jax.Array) -> jax.Array:
    """sum_f V[f]^T C[f] V[f] for V (..., F, B, D), C (..., F, B, B) -> (..., D, D).

    D = n^2 is the flattened outer-product dimension (9 affine, 16
    projective); B is the per-image basis size (<= 4). The result is the
    flattened ``B_cal``/``A_cal`` matrix, symmetric whenever each C is.
    """
    return jnp.einsum("...fab,...fai,...fbj->...ij", c, v, v, precision=HIGHEST)


def _pairs(n: int) -> list[tuple[int, int]]:
    """Off-diagonal pair ordering used by the reference packings.

    n=3: ((i+1)%3, (i+2)%3) -> [(1,2), (2,0), (0,1)]
         (``affine_camera_calibration.py:249-253`` and the tau->T layout at
         ``:259-269``).
    n=4: upper-triangle lexicographic [(0,1), (0,2), (0,3), (1,2), (1,3),
         (2,3)] (``perspective_camera_calibration.py:279`` and the
         omega->Omega layout at ``:296-307``).
    """
    if n == 3:
        return [(1, 2), (2, 0), (0, 1)]
    return [(i, j) for i in range(n) for j in range(i + 1, n)]


def sym_reduce(bcal_flat: jax.Array, n: int) -> jax.Array:
    """Flattened (n^2, n^2) fourth-moment matrix -> reduced symmetric-space
    matrix of size (n + |pairs|): 6x6 for n=3, 10x10 for n=4.

    Entry conventions (1 on diag-diag, sqrt(2) on diag-pair, 2 on
    pair-pair) follow ``affine_camera_calibration.py:243-256`` /
    ``perspective_camera_calibration.py:274-294``.
    """
    pairs = _pairs(n)
    m = len(pairs)
    dim = n + m
    # Row/col index (into the flattened n^2 axis) and weight per reduced slot.
    idx = np.empty(dim, dtype=np.int64)
    wgt = np.empty(dim, dtype=np.float64)
    for a in range(n):
        idx[a] = a * n + a
        wgt[a] = 1.0
    for q, (i, j) in enumerate(pairs):
        idx[n + q] = i * n + j
        wgt[n + q] = np.sqrt(2.0)
    sub = bcal_flat[jnp.ix_(jnp.asarray(idx), jnp.asarray(idx))]
    w = jnp.asarray(wgt, dtype=bcal_flat.dtype)
    return sub * w[:, None] * w[None, :]


def sym_expand(tau: jax.Array, n: int) -> jax.Array:
    """Reduced symmetric vector (n + |pairs|,) -> symmetric (n, n) matrix
    with off-diagonals divided by sqrt(2)
    (``affine_camera_calibration.py:259-269`` for n=3 (T);
    ``perspective_camera_calibration.py:296-307`` for n=4 (Omega))."""
    pairs = _pairs(n)
    diag_part = jnp.zeros((n, n), dtype=tau.dtype)
    diag_part = diag_part + jnp.diag(tau[:n])
    off = jnp.zeros((n, n), dtype=tau.dtype)
    inv_sqrt2 = float(1.0 / np.sqrt(2.0))  # weak scalar: no f64 promotion
    for q, (i, j) in enumerate(pairs):
        off = off.at[i, j].set(tau[n + q] * inv_sqrt2)
        off = off.at[j, i].set(tau[n + q] * inv_sqrt2)
    return diag_part + off


# Backwards-friendly aliases used by ops/__init__.
sym_pack = sym_reduce
sym_unpack = sym_expand
