"""Independent correctness oracle: the analytic BA gradients (ported from
Kanatani's formulas) must equal JAX autodiff of the error function.

This is a framework-native test the reference cannot have: jax.grad of
the reprojection error wrt points and camera parameters, compared against
the hand-derived d_P / d_F used in the Schur solver."""

import numpy as np
import jax
import jax.numpy as jnp

from mvrecon_tpu.models.bundle_adjustment import (
    BAState,
    _compute_derivs,
    build_K,
    calc_pqr,
    gauge_mask,
    normalize_gauge,
    reprojection_error,
)
from mvrecon_tpu.ops.rotations import rodrigues

from conftest import make_ref_scene


def _state(ref, quiet):
    _, _, _, _, x_list = make_ref_scene(ref, n_images=8)
    import numpy as np

    with quiet():
        X_, R_ = ref.affine.paraperspective_self_calibration(
            [x.copy() for x in x_list], np.ones(8)
        )
    t_ = -3 * R_[:, :, 2]
    x = jnp.asarray(np.stack(x_list).transpose(1, 0, 2))
    Xn, Rn, tn, _ = normalize_gauge(
        jnp.asarray(X_), jnp.asarray(R_), jnp.asarray(t_), "x-up_z-forward"
    )
    state = BAState(
        X=Xn, f=jnp.ones((8,), x.dtype), u=jnp.zeros((8, 2), x.dtype), t=tn, R=Rn
    )
    return x, state


def test_gradients_match_autodiff(ref, quiet):
    x, state = _state(ref, quiet)
    nf = state.f.shape[0]
    vis = jnp.ones(x.shape[:2], x.dtype)
    free = gauge_mask(nf, "x-up_z-forward", x.dtype)

    derivs, _ = _compute_derivs(state, x, vis, free, 1.0)

    def error_at(X, f, u, t, omega):
        # omega parameterizes a left-multiplied rotation update, matching
        # the derivative convention (R <- exp([omega]x) R)
        R = rodrigues(omega) @ state.R
        K = build_K(f, u, 1.0)
        _, p, q, r = calc_pqr(X, K, R, t)
        return reprojection_error(x, p, q, r, vis, 1.0)

    omega0 = jnp.zeros((nf, 3), x.dtype)
    grads = jax.grad(error_at, argnums=(0, 1, 2, 3, 4))(
        state.X, state.f, state.u, state.t, omega0
    )
    gX, gf, gu, gt, gw = grads

    np.testing.assert_allclose(np.asarray(derivs.d_P), np.asarray(gX), atol=1e-9)

    g_cam = jnp.concatenate([gf[:, None], gu, gt, gw], axis=1).reshape(-1)
    g_cam = g_cam * free  # gauge-fixed entries are zeroed in d_F
    np.testing.assert_allclose(np.asarray(derivs.d_F), np.asarray(g_cam), atol=1e-9)


def test_gauss_newton_blocks_are_jtj(ref, quiet):
    """matE must equal 2 J_X^T J_X of the weighted residual vector — the
    Gauss-Newton structure (reference drops the second-order residual term;
    verify ours does exactly the same)."""
    x, state = _state(ref, quiet)
    vis = jnp.ones(x.shape[:2], x.dtype)
    free = gauge_mask(state.f.shape[0], "x-up_z-forward", x.dtype)
    derivs, _ = _compute_derivs(state, x, vis, free, 1.0)

    # residuals for a single point as a function of its position
    def residuals_point(Xp, pidx):
        K = build_K(state.f, state.u, 1.0)
        Xfull = state.X.at[pidx].set(Xp)
        _, p, q, r = calc_pqr(Xfull, K, state.R, state.t)
        res = jnp.stack(
            [p[pidx] / r[pidx] - x[pidx, :, 0], q[pidx] / r[pidx] - x[pidx, :, 1]],
            axis=-1,
        )  # (F, 2)
        return res.reshape(-1)

    for pidx in (0, 57, 199):
        J = jax.jacfwd(residuals_point)(state.X[pidx], pidx)  # (2F, 3)
        expected = 2.0 * J.T @ J
        np.testing.assert_allclose(
            np.asarray(derivs.matE[pidx]), np.asarray(expected), atol=1e-9
        )
