"""End-to-end pipeline tests (the framework's analog of the reference's
two demo drivers as golden-path integration tests, SURVEY.md §4)."""

import numpy as np
import jax
import jax.numpy as jnp

from mvrecon_tpu.config import LMConfig
from mvrecon_tpu.geometry.camera import project_points
from mvrecon_tpu.geometry.scenes import make_synthetic_scene
from mvrecon_tpu.models.pipelines import affine_reconstruction, euclidean_reconstruction


def _rms(res, x_obs):
    reproj = project_points(res.X, res.K, res.R, res.t)
    return float(jnp.sqrt(jnp.mean((reproj - x_obs) ** 2)))


def test_euclidean_pipeline_e2e():
    scene = make_synthetic_scene(jax.random.key(123), n_images=10)
    res = euclidean_reconstruction(
        scene.x, config=LMConfig(scale_factor=2.0, delta_tol=1e-8, max_iter=50)
    )
    assert int(res.status) == 0
    # reprojection must reach the sigma=0.005 noise floor
    assert _rms(res, scene.x) < 0.006
    # BA must improve on the calibration-only reconstruction
    assert np.isfinite(float(res.error))


def test_affine_pipeline_e2e():
    scene = make_synthetic_scene(jax.random.key(123), n_images=12)
    f = jnp.ones((12,), dtype=scene.x.dtype)
    res = affine_reconstruction(
        scene.x, f, config=LMConfig(scale_factor=2.0, delta_tol=1e-8, max_iter=50)
    )
    assert _rms(res, scene.x) < 0.006


def test_euclidean_pipeline_float32():
    """The fast path (f32) must still reconstruct to near the noise
    floor."""
    scene = make_synthetic_scene(jax.random.key(3), n_images=10, dtype=jnp.float32)
    res = euclidean_reconstruction(
        scene.x, config=LMConfig(scale_factor=2.0, delta_tol=1e-8, max_iter=50)
    )
    assert res.X.dtype == jnp.float32
    assert int(res.status) == 0
    assert _rms(res, scene.x) < 0.01


def test_euclidean_pipeline_power_eig():
    """The power-iteration depth option must reconstruct to the same
    quality as full eigh (same fixed point, same stopping rule)."""
    scene = make_synthetic_scene(jax.random.key(123), n_images=10)
    res = euclidean_reconstruction(
        scene.x, eig_method="power",
        config=LMConfig(scale_factor=2.0, delta_tol=1e-8, max_iter=50),
    )
    assert int(res.status) == 0
    assert _rms(res, scene.x) < 0.006


def test_pipeline_records_ba_log_for_animation():
    """config.record_log surfaces the stacked BA iteration log through the
    pipeline result (the reference's get_log/animate replay,
    euclidiean_reconstruction.py:57-66); records convert and errors are
    monotone over accepted iterations."""
    from mvrecon_tpu.runtime.logging import device_log_to_records

    scene = make_synthetic_scene(jax.random.key(1), n_images=6)
    x = scene.x
    res = euclidean_reconstruction(
        x, f0=1.0, tol=1e-2, method="dual",
        config=LMConfig(scale_factor=2.0, delta_tol=1e-8, max_iter=8,
                        record_log=True),
    )
    assert res.ba_log is not None
    records = device_log_to_records(res.ba_log, res.n_iter)
    assert len(records) == int(res.n_iter) + 1
    errs = [r["reprojection_error"] for r in records]
    assert all(b <= a + 1e-12 for a, b in zip(errs, errs[1:]))
    assert records[0]["points"].shape == (x.shape[1], 3)

    # default config keeps the result trajectory-free (no memory cost):
    # only O(1) scalars remain — the damping carry (c, nu), which the
    # batched to-convergence compaction resumes from, and the retry count
    res2 = euclidean_reconstruction(
        x, f0=1.0, tol=1e-2, method="dual",
        config=LMConfig(scale_factor=2.0, delta_tol=1e-8, max_iter=4),
    )
    assert set(res2.ba_log) == {"c", "nu", "n_solver_retries"}
    assert np.asarray(res2.ba_log["n_solver_retries"]).shape == ()
    assert np.asarray(res2.ba_log["c"]).shape == ()


def test_euclidean_pipeline_large_short_budget():
    """euclidean_reconstruction_large (round 5): with the projective-
    scale K normalization (intrinsics_from_K) the calibration init
    enters BA at ~1.04x the noise floor, so a SHORT full-scale budget
    reaches the floor — before the fix this shape needed ~16
    iterations (scripts/exp_pipeline_init.py)."""
    from mvrecon_tpu.models.pipelines import euclidean_reconstruction_large

    scene = make_synthetic_scene(
        jax.random.key(7), n_images=24, n_slices=40, n_angles=20,
        dtype=jnp.float32,
    )
    n_points, n_views = scene.x.shape[1], scene.x.shape[0]
    noise_floor = n_points * n_views * 2 * 0.005**2
    res = euclidean_reconstruction_large(
        scene.x,
        config=LMConfig(
            scale_factor=4.0, delta_tol=0.0, max_iter=3,
            accept_divisor=1.0, init_damping=3e-3, damping="nielsen",
        ),
        chunk_size=256,
    )
    assert int(res.status) == 0
    assert float(res.error) <= 1.1 * noise_floor
    assert _rms(res, scene.x) < 0.006


def test_euclidean_pipeline_large_bootstrap_path():
    """The hierarchical bootstrap path (weak-init recovery): subsample
    camera BA + DLT re-triangulation must also reach the floor when
    given enough bootstrap iterations to converge."""
    from mvrecon_tpu.models.pipelines import euclidean_reconstruction_large

    scene = make_synthetic_scene(
        jax.random.key(7), n_images=24, n_slices=40, n_angles=20,
        dtype=jnp.float32,
    )
    n_points, n_views = scene.x.shape[1], scene.x.shape[0]
    noise_floor = n_points * n_views * 2 * 0.005**2
    res = euclidean_reconstruction_large(
        scene.x,
        config=LMConfig(
            scale_factor=4.0, delta_tol=0.0, max_iter=6,
            accept_divisor=1.0, init_damping=3e-3, damping="nielsen",
        ),
        chunk_size=256, bootstrap_frac=0.1, bootstrap_iters=12,
    )
    assert int(res.status) == 0
    assert float(res.error) <= 1.1 * noise_floor
    assert _rms(res, scene.x) < 0.006
