"""Small-matrix linear algebra kernels.

Rationale: the pipelines are dominated by *batched tiny* problems
(3x3 inverses at 100k points, 6x6/10x10 symmetric eigenproblems, batched
F x F / P x P eigh). General LAPACK-style ``np.linalg.eig`` (reference
``affine_camera_calibration.py:120,207``, ``perspective_camera_calibration
.py:311,315``) has no accelerator lowering — but every matrix the reference feeds it
(B, A, Omega) is symmetric by construction, so ``eigh`` is the native
replacement. 3x3 inverses (reference ``bundle_adjustment.py:128``) use the
closed-form adjugate: one fused VPU expression instead of a LU factorization,
which is what lets the Schur point-block elimination stay on-device at 100k
points.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def inv3x3(m: jax.Array) -> jax.Array:
    """Closed-form adjugate inverse of (..., 3, 3) matrices.

    Replaces ``np.linalg.inv`` on the BA point blocks (reference
    ``bundle_adjustment.py:128``): elementwise VPU math, no factorization,
    vmap/shard-friendly.
    """
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    I = a * e - b * d

    det = a * A + b * B + c * C
    inv_det = 1.0 / det
    adj = jnp.stack(
        [
            jnp.stack([A, D, G], axis=-1),
            jnp.stack([B, E, H], axis=-1),
            jnp.stack([C, F, I], axis=-1),
        ],
        axis=-2,
    )
    return adj * inv_det[..., None, None]


def det3x3(m: jax.Array) -> jax.Array:
    """Closed-form determinant of (..., 3, 3) matrices (batched
    ``jnp.linalg.det`` goes through an LU custom call)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def solve3x3(m: jax.Array, b: jax.Array) -> jax.Array:
    """Solve (..., 3, 3) @ x = (..., 3) via the adjugate inverse."""
    return jnp.einsum("...ij,...j->...i", inv3x3(m), b)


def min_eigvec_sym(a: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(eigenvalue, eigenvector) of the smallest eigenvalue of a symmetric
    matrix. ``eigh`` returns ascending order, so index 0.

    Replaces the reference's min-eigenvalue selection over ``np.linalg.eig``
    output (``affine_camera_calibration.py:120-121,207-208``,
    ``perspective_camera_calibration.py:311-312``).
    """
    w, v = jnp.linalg.eigh(a)
    return w[..., 0], v[..., :, 0]


def max_eigvec_sym(a: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(eigenvalue, eigenvector) of the largest eigenvalue of a symmetric
    matrix (reference max-eig selection at
    ``perspective_camera_calibration.py:115,207``)."""
    w, v = jnp.linalg.eigh(a)
    return w[..., -1], v[..., :, -1]


def orthonormalize(r: jax.Array) -> jax.Array:
    """Project (..., 3, 3) matrices to the nearest orthogonal matrix —
    the SVD polar factor U @ Vt (reference ``affine_camera_calibration.py:
    338-339``, ``perspective_camera_calibration.py:434-437``), computed
    custom-call-free as A (A^T A)^{-1/2} (see ``polar_orthogonal3``)."""
    return polar_orthogonal3(r)


def polar_orthogonal3(a: jax.Array) -> jax.Array:
    """Nearest orthogonal factor of (..., 3, 3) matrices as
    A (A^T A)^{-1/2}, with the tiny symmetric inverse square root from
    ``jacobi_eigh`` — pure XLA. Identical to the SVD polar factor U V^T
    for nonsingular A (det sign preserved); intended for near-orthogonal
    inputs (rotation recovery), where a batched 3x3 SVD is a pure
    latency-bound custom call (elementwise math here).

    (Near-)singular input — where A (A^T A)^{-1/2} is 0/0 along the null
    direction(s) while the SVD polar factor stays well-defined — takes a
    per-element orthogonal-completion branch instead: left vectors of the
    healthy singular directions, the rest completed by cross products
    (the polar factor of rank-deficient A is non-unique; any orthogonal
    completion is a nearest orthogonal matrix). Healthy matrices are
    untouched (bit-identical to the original formula).
    """
    dt = a.dtype
    eps = jnp.finfo(dt).eps
    tiny = jnp.finfo(dt).tiny
    hp = jax.lax.Precision.HIGHEST
    g = jnp.einsum("...ji,...jk->...ik", a, a, precision=hp)
    w, v = jacobi_eigh(g)  # ascending
    wc = jnp.maximum(w, tiny)
    inv_sqrt = jnp.einsum(
        "...ik,...k,...jk->...ij", v, 1.0 / jnp.sqrt(wc), v, precision=hp
    )
    direct = a @ inv_sqrt

    # Gram-eigenvalue cutoff: forming A^T A leaves absolute noise of
    # order eps * w_max in every entry, so an exactly-zero singular
    # value shows up as w_0 ~ eps * w_max (NOT eps^2) — the cutoff is
    # linear in eps, i.e. s_0 <~ sqrt(32 eps) s_max is numerically null
    # (below that the direct formula's null direction is noise anyway).
    healthy = w[..., 0] > 32.0 * eps * w[..., 2]

    def _unit(x, fallback):
        n = jnp.linalg.norm(x, axis=-1, keepdims=True)
        ok = n > tiny**0.5
        return jnp.where(ok, x / jnp.where(ok, n, 1.0), fallback)

    av = jnp.einsum("...ij,...jk->...ik", a, v, precision=hp)  # A v_k cols
    e_z = jnp.zeros_like(av[..., 2]).at[..., 2].set(1.0)
    u2 = _unit(av[..., 2], e_z)  # largest direction (zero A -> e_z)
    # least-aligned basis vector as the rank-1 fallback seed for u1
    idx = jnp.argmin(jnp.abs(u2), axis=-1)
    e_min = jax.nn.one_hot(idx, 3, dtype=dt)
    alt1 = e_min - jnp.sum(e_min * u2, axis=-1, keepdims=True) * u2
    cand1 = av[..., 1] - jnp.sum(av[..., 1] * u2, axis=-1, keepdims=True) * u2
    u1 = _unit(cand1, _unit(alt1, e_min))
    u0 = jnp.cross(u2, u1)
    u_cols = jnp.stack([u0, u1, u2], axis=-1)
    completed = jnp.einsum("...ik,...jk->...ij", u_cols, v, precision=hp)

    return jnp.where(healthy[..., None, None], direct, completed)


def chol3x3(m: jax.Array) -> jax.Array:
    """Closed-form Cholesky L (lower) of (..., 3, 3) SPD matrices —
    elementwise VPU math, batched."""
    a11, a21, a31 = m[..., 0, 0], m[..., 1, 0], m[..., 2, 0]
    a22, a32, a33 = m[..., 1, 1], m[..., 2, 1], m[..., 2, 2]
    l11 = jnp.sqrt(a11)
    l21 = a21 / l11
    l31 = a31 / l11
    l22 = jnp.sqrt(a22 - l21 * l21)
    l32 = (a32 - l31 * l21) / l22
    l33 = jnp.sqrt(a33 - l31 * l31 - l32 * l32)
    z = jnp.zeros_like(l11)
    return jnp.stack(
        [
            jnp.stack([l11, z, z], axis=-1),
            jnp.stack([l21, l22, z], axis=-1),
            jnp.stack([l31, l32, l33], axis=-1),
        ],
        axis=-2,
    )


def solve_lower3(l: jax.Array, b: jax.Array) -> jax.Array:
    """Forward substitution L y = b for (..., 3, 3) lower-triangular L and
    (..., 3, N) rhs (closed form, batched)."""
    y0 = b[..., 0, :] / l[..., 0, 0, None]
    y1 = (b[..., 1, :] - l[..., 1, 0, None] * y0) / l[..., 1, 1, None]
    y2 = (
        b[..., 2, :] - l[..., 2, 0, None] * y0 - l[..., 2, 1, None] * y1
    ) / l[..., 2, 2, None]
    return jnp.stack([y0, y1, y2], axis=-2)


def inv_lower3(l: jax.Array) -> jax.Array:
    """Closed-form inverse of (..., 3, 3) lower-triangular matrices.
    Turning L^-1 into an explicit operand lets the big triangular solve
    L^-1 B become ONE batched matmul-shaped einsum (better layout/fusion
    than the 3-step substitution, which materializes a stack)."""
    i11 = 1.0 / l[..., 0, 0]
    i22 = 1.0 / l[..., 1, 1]
    i33 = 1.0 / l[..., 2, 2]
    i21 = -l[..., 1, 0] * i11 * i22
    i31 = (l[..., 1, 0] * l[..., 2, 1] - l[..., 2, 0] * l[..., 1, 1]) * i11 * i22 * i33
    i32 = -l[..., 2, 1] * i22 * i33
    z = jnp.zeros_like(i11)
    return jnp.stack(
        [
            jnp.stack([i11, z, z], axis=-1),
            jnp.stack([i21, i22, z], axis=-1),
            jnp.stack([i31, i32, i33], axis=-1),
        ],
        axis=-2,
    )


def chol9_blocks(g: jax.Array) -> jax.Array:
    """Closed-form Cholesky L (lower) of (..., 9, 9) SPD matrices via
    3x3-blocked elimination — pure batched elementwise/3x3 math, no
    LAPACK-style custom call, which is latency-bound at this size."""
    A = g[..., 0:3, 0:3]
    B = g[..., 3:6, 0:3]
    C = g[..., 6:9, 0:3]
    D = g[..., 3:6, 3:6]
    E = g[..., 6:9, 3:6]
    F = g[..., 6:9, 6:9]

    # HIGHEST precision throughout: these 3x3 products are negligible
    # FLOPs, but the Schur-complement subtractions (D - L21 L21^T, ...)
    # cancel almost completely for ill-conditioned blocks (e.g. the
    # SCHUR_JACOBI preconditioner blocks of window-visibility BA), and a
    # bf16-pass product there makes the remainder indefinite ->
    # sqrt(negative) -> a NaN preconditioner (round-5 root cause of the
    # sparse core's never-accepting LM storms).
    hp = jax.lax.Precision.HIGHEST
    l11 = chol3x3(A)
    i11 = inv_lower3(l11)
    l21 = jnp.einsum("...ij,...kj->...ik", B, i11, precision=hp)  # B L11^-T
    l31 = jnp.einsum("...ij,...kj->...ik", C, i11, precision=hp)
    s22 = D - jnp.einsum("...ij,...kj->...ik", l21, l21, precision=hp)
    l22 = chol3x3(s22)
    i22 = inv_lower3(l22)
    s32 = E - jnp.einsum("...ij,...kj->...ik", l31, l21, precision=hp)
    l32 = jnp.einsum("...ij,...kj->...ik", s32, i22, precision=hp)
    s33 = F - jnp.einsum("...ij,...kj->...ik", l31, l31, precision=hp) \
        - jnp.einsum("...ij,...kj->...ik", l32, l32, precision=hp)
    l33 = chol3x3(s33)

    z = jnp.zeros_like(l11)
    top = jnp.concatenate([l11, z, z], axis=-1)
    mid = jnp.concatenate([l21, l22, z], axis=-1)
    bot = jnp.concatenate([l31, l32, l33], axis=-1)
    return jnp.concatenate([top, mid, bot], axis=-2)


def inv9_spd(g: jax.Array) -> jax.Array:
    """Closed-form inverse of (..., 9, 9) SPD matrices (the damped BA
    camera blocks): blocked Cholesky + blocked triangular inversion,
    G^-1 = L^-T L^-1. Replaces ``jnp.linalg.inv`` on the camera blocks
    (a latency-bound custom call at this size)."""
    hp = jax.lax.Precision.HIGHEST
    l = chol9_blocks(g)
    i11 = inv_lower3(l[..., 0:3, 0:3])
    i22 = inv_lower3(l[..., 3:6, 3:6])
    i33 = inv_lower3(l[..., 6:9, 6:9])
    l21 = l[..., 3:6, 0:3]
    l31 = l[..., 6:9, 0:3]
    l32 = l[..., 6:9, 3:6]
    m21 = -jnp.einsum("...ij,...jk,...kl->...il", i22, l21, i11,
                      precision=hp)
    m32 = -jnp.einsum("...ij,...jk,...kl->...il", i33, l32, i22,
                      precision=hp)
    m31 = -jnp.einsum(
        "...ij,...jk->...ik", i33,
        jnp.einsum("...ij,...jk->...ik", l31, i11, precision=hp)
        + jnp.einsum("...ij,...jk->...ik", l32, m21, precision=hp),
        precision=hp,
    )
    z = jnp.zeros_like(i11)
    top = jnp.concatenate([i11, z, z], axis=-1)
    mid = jnp.concatenate([m21, i22, z], axis=-1)
    bot = jnp.concatenate([m31, m32, i33], axis=-1)
    linv = jnp.concatenate([top, mid, bot], axis=-2)
    return jnp.einsum("...ji,...jk->...ik", linv, linv, precision=hp)


def _round_robin_pairs(n: int):
    """Static round-robin (circle method) pairings: n-1 rounds of n/2
    disjoint pairs covering all index pairs exactly once per sweep.
    ``n`` must be even."""
    idx = list(range(n))
    rounds = []
    for _ in range(n - 1):
        rounds.append([(min(idx[i], idx[n - 1 - i]), max(idx[i], idx[n - 1 - i]))
                       for i in range(n // 2)])
        idx = [idx[0]] + [idx[-1]] + idx[1:-1]  # rotate all but the first
    return rounds


def jacobi_eigh(
    a: jax.Array, max_sweeps: int = 15
) -> tuple[jax.Array, jax.Array]:
    """Batched symmetric eigendecomposition for small n via two-sided
    cyclic Jacobi with parallel round-robin orderings — pure XLA
    (elementwise ops + static gathers), no LAPACK-style custom call.

    Rationale: ``jnp.linalg.eigh`` on a (3200, 12, 12) batch lowers to a
    custom call that is *latency*-bound at tiny n; a Jacobi sweep
    applies all n/2 disjoint rotations of a round simultaneously across
    the whole batch as fused elementwise math. Quadratic convergence: ``max_sweeps``
    defaults far beyond what n <= 16 needs; an off(A)-based early exit
    stops typical batches after 5-8 sweeps. Exact to fp — same contract
    as ``eigh`` (ascending eigenvalues, ``v[..., :, k]`` the k-th
    eigenvector), eigenvector signs unspecified as usual.

    Intended for n <= 32 (call sites use 4x4-12x12). Beyond that the
    default ``max_sweeps`` may exit before the off(A) test passes and
    silently return degraded eigenpairs — asserted here rather than
    surfaced as a flag, since every caller is in-graph.
    """
    n = a.shape[-1]
    if n > 32:
        raise ValueError(
            f"jacobi_eigh is tuned for n <= 32 (got n={n}); use "
            "jnp.linalg.eigh or raise max_sweeps with care"
        )
    dt = a.dtype
    odd = n % 2
    if odd:
        # decoupled padding index: its off-diagonals are zero and stay
        # zero under every rotation (angle 0), so the extra eigenpair
        # never mixes and is dropped before sorting
        a = jnp.pad(a, [(0, 0)] * (a.ndim - 2) + [(0, 1), (0, 1)])
    m = n + odd
    eps = jnp.finfo(dt).eps
    # zeros_like keeps `a`'s device-variance type so the while/scan
    # carries stay consistent under shard_map
    v0 = jnp.zeros_like(a) + jnp.eye(m, dtype=dt)

    # Static per-round tables: partner permutation + "am I the smaller
    # (p) member of my pair" mask, stacked so a traced round index works.
    perm_rows, pmask_rows = [], []
    for prs in _round_robin_pairs(m):
        part = [0] * m
        pmask = [0.0] * m
        for (p, q) in prs:
            part[p], part[q] = q, p
            pmask[p] = 1.0
        perm_rows.append(part)
        pmask_rows.append(pmask)
    perms_arr = jnp.asarray(perm_rows)  # (R, m) int
    pmask_arr = jnp.asarray(pmask_rows, dtype=dt)  # (R, m) 1.0 at p

    def one_round(av, r):
        a_cur, v_cur = av
        perm = perms_arr[r]
        pmask = pmask_arr[r]

        diag = jnp.diagonal(a_cur, axis1=-2, axis2=-1)  # (..., m)
        # A[..., i, perm[i]] — the pair's off-diagonal entry seen from i
        idx = jnp.broadcast_to(perm[:, None], a_cur.shape[:-1] + (1,))
        apq = jnp.take_along_axis(a_cur, idx, axis=-1)[..., 0]
        app = diag
        aqq = diag[..., perm]
        small = jnp.abs(apq) <= eps * (jnp.abs(app) + jnp.abs(aqq) + eps)
        tau = (aqq - app) / jnp.where(small, 1.0, 2.0 * apq)
        # classic stable tangent; sign(0) := +1 so tau = 0 gives the
        # exact 45-degree rotation instead of a no-op
        sgn_tau = jnp.where(tau >= 0, 1.0, -1.0).astype(dt)
        t = sgn_tau / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
        t = jnp.where(small, 0.0, t)
        c = 1.0 / jnp.sqrt(1.0 + t * t)
        s = t * c
        # both members of a pair use the p-member's (c, s)
        c_pair = pmask * c + (1.0 - pmask) * c[..., perm]
        s_pair = pmask * s + (1.0 - pmask) * s[..., perm]
        sgn = 1.0 - 2.0 * pmask  # -1 at p, +1 at q

        # rows:    row_p' = c row_p - s row_q ; row_q' = s row_p + c row_q
        a_rows = (
            c_pair[..., :, None] * a_cur
            + (sgn * s_pair)[..., :, None] * a_cur[..., perm, :]
        )
        # columns: col_p' = c col_p - s col_q ; col_q' = s col_p + c col_q
        a_new = (
            c_pair[..., None, :] * a_rows
            + (sgn * s_pair)[..., None, :] * a_rows[..., :, perm]
        )
        v_new = (
            c_pair[..., None, :] * v_cur
            + (sgn * s_pair)[..., None, :] * v_cur[..., :, perm]
        )
        a_new = 0.5 * (a_new + jnp.swapaxes(a_new, -1, -2))
        return (a_new, v_new), None

    n_rounds = perms_arr.shape[0]

    def sweep(carry):
        a_cur, v_cur, k = carry
        (a_cur, v_cur), _ = jax.lax.scan(
            one_round, (a_cur, v_cur), jnp.arange(n_rounds)
        )
        return a_cur, v_cur, k + 1

    def not_converged(carry):
        a_cur, _, k = carry
        diag = jnp.diagonal(a_cur, axis1=-2, axis2=-1)
        off = a_cur - diag[..., None] * jnp.eye(m, dtype=dt)
        num = jnp.sum(off * off, axis=(-2, -1))
        den = jnp.sum(a_cur * a_cur, axis=(-2, -1)) + eps
        return (jnp.max(num / den) > (10 * eps) ** 2) & (k < max_sweeps)

    a_f, v_f, _ = jax.lax.while_loop(
        not_converged, sweep, (a, v0, jnp.asarray(0))
    )
    w = jnp.diagonal(a_f, axis1=-2, axis2=-1)
    if odd:
        w = w[..., :n]
        v_f = v_f[..., :n, :n]
    order = jnp.argsort(w, axis=-1)
    w = jnp.take_along_axis(w, order, axis=-1)
    v_f = jnp.take_along_axis(v_f, order[..., None, :], axis=-1)
    return w, v_f


def blockdiag_scatter(blocks: jax.Array) -> jax.Array:
    """(F, K, K) -> (F*K, F*K) block-diagonal matrix, statically shaped.

    Traceable replacement for ``scipy.linalg.block_diag`` (reference
    ``bundle_adjustment.py:656``): writes blocks onto the (i == j) diagonal
    of the (F, K, F, K) view with one scatter-free ``where`` over an iota
    mask — XLA fuses it into the consumer.
    """
    nf, k, _ = blocks.shape
    eye_f = jnp.eye(nf, dtype=blocks.dtype)
    out = jnp.einsum("fg,fkl->fkgl", eye_f, blocks)
    return out.reshape(nf * k, nf * k)
