"""Multi-view triangulation with known cameras.

The reference recovers structure only through factorization (no standalone
triangulation module), but a reconstruction framework needs one: given
calibrated cameras and tracked observations, recover 3D points directly.
This is the homogeneous DLT (direct linear transform) solved per point,
batched over all points with one (P, 2F, 4) stacked system — the smallest-
singular-vector problem maps to a batched 4x4 symmetric eigendecomposition
(Gram trick) so the whole thing is einsum + eigh, vmappable over
scenes.

With a visibility mask, invisible rows are zeroed (they contribute nothing
to the normal matrix), so ragged tracks triangulate without ragged shapes.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import HIGHEST


def _camera_matrix(K, R, t):
    # imported lazily: geometry.camera itself imports the ops package
    from ..geometry.camera import camera_matrix

    return camera_matrix(K, R, t)


@partial(jax.jit, static_argnames=("f0",))
def triangulate(
    x: jax.Array,
    K: jax.Array,
    R: jax.Array,
    t: jax.Array,
    visibility: jax.Array | None = None,
    f0: float = 1.0,
) -> jax.Array:
    """DLT-triangulate observations x (F, P, 2) through cameras
    (K, R, t) -> points (P, 3).

    Per point, rows of the design matrix are (x/f0 * P3 - P1) and
    (y/f0 * P3 - P2) per camera; the point is the least-squares null
    vector, computed from the 4x4 Gram matrix's smallest eigenvector.
    """
    pmat = _camera_matrix(K, R, t)  # (F, 3, 4)
    p1, p2, p3 = pmat[:, 0], pmat[:, 1], pmat[:, 2]  # (F, 4)

    u = x[..., 0] / f0  # (F, P)
    v = x[..., 1] / f0

    # rows: (F, P, 4)
    row_u = u[..., None] * p3[:, None, :] - p1[:, None, :]
    row_v = v[..., None] * p3[:, None, :] - p2[:, None, :]

    if visibility is not None:
        vis = jnp.asarray(visibility, dtype=x.dtype).T[..., None]  # (F, P, 1)
        row_u = row_u * vis
        row_v = row_v * vis

    # Gram matrix per point: (P, 4, 4)
    gram = jnp.einsum("fpi,fpj->pij", row_u, row_u, precision=HIGHEST)
    gram = gram + jnp.einsum("fpi,fpj->pij", row_v, row_v, precision=HIGHEST)

    _, vecs = jnp.linalg.eigh(gram)
    xh = vecs[..., :, 0]  # smallest eigenvector (P, 4)
    # normalize homogeneous coordinate; guard sign/zero
    w = xh[..., 3:]
    w = jnp.where(jnp.abs(w) < 1e-12, jnp.where(w < 0, -1e-12, 1e-12), w)
    return xh[..., :3] / w


@partial(jax.jit, static_argnames=("n_points", "f0"))
def triangulate_sparse(
    point_idx: jax.Array,
    cam_idx: jax.Array,
    xy: jax.Array,
    n_points: int,
    K: jax.Array,
    R: jax.Array,
    t: jax.Array,
    weights: jax.Array | None = None,
    f0: float = 1.0,
) -> jax.Array:
    """Observation-list DLT triangulation -> points (n_points, 3).

    Same homogeneous DLT as :func:`triangulate`, but over a flat
    observation list (``point_idx (N,)``, ``cam_idx (N,)``, ``xy (N, 2)``,
    sorted by point id — the ``SparseObs`` layout of
    ``models/bundle_adjustment_sparse.py``): per-observation design rows
    by camera gathers, per-point 4x4 Gram matrices by sorted
    ``segment_sum``, smallest eigenvector per point. O(n_obs) memory —
    the initializer for BAL-class problems whose file points are absent
    or untrusted. Optional per-observation ``weights`` scale each
    observation's Gram contribution (zero = padding). Points with no
    (weighted) observations come back at the origin.
    """
    pmat = _camera_matrix(K, R, t)  # (F, 3, 4)
    pg = pmat[cam_idx]  # (N, 3, 4)
    u = xy[..., 0] / f0  # (N,)
    v = xy[..., 1] / f0
    row_u = u[:, None] * pg[:, 2] - pg[:, 0]  # (N, 4)
    row_v = v[:, None] * pg[:, 2] - pg[:, 1]
    contrib = (
        jnp.einsum("ni,nj->nij", row_u, row_u, precision=HIGHEST)
        + jnp.einsum("ni,nj->nij", row_v, row_v, precision=HIGHEST)
    )
    if weights is not None:
        contrib = weights[:, None, None] * contrib
    gram = jax.ops.segment_sum(
        contrib, point_idx, num_segments=n_points, indices_are_sorted=True
    )
    # unseen points: identity Gram -> eigh stays well-posed; the smallest
    # eigenvector is then arbitrary, so zero those points explicitly
    seen = jnp.trace(gram, axis1=-2, axis2=-1) > 0
    eye = jnp.eye(4, dtype=gram.dtype)
    gram = jnp.where(seen[:, None, None], gram, eye)
    _, vecs = jnp.linalg.eigh(gram)
    xh = vecs[..., :, 0]
    w = xh[..., 3:]
    w = jnp.where(jnp.abs(w) < 1e-12, jnp.where(w < 0, -1e-12, 1e-12), w)
    return jnp.where(seen[:, None], xh[..., :3] / w, 0.0)
