"""CPU checks of the GPU path's pieces: the chunked core's reduced camera
system against the dense core's, the compile-cache rule, the entry
points that must refuse a machine without a GPU (chip_smoke.py,
bench.py), their workloads at small shapes, and the SYRK kernel's
wrappers."""

import contextlib
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import bench  # noqa: E402
import chip_smoke  # noqa: E402
from mvrecon_tpu.config import LMConfig  # noqa: E402
from mvrecon_tpu.geometry.scenes import make_synthetic_scene  # noqa: E402
from mvrecon_tpu.models.bundle_adjustment import (  # noqa: E402
    _compute_derivs,
    _huber_weights,
    bundle_adjust,
    reduced_camera_system,
)
from mvrecon_tpu.models.bundle_adjustment_chunked import (  # noqa: E402
    _build_system,
    bundle_adjust_chunked,
    chunk_points,
)


def _scene(n_views=8, n_slices=20, dtype=jnp.float64, seed=0):
    sc = make_synthetic_scene(jax.random.key(seed), n_images=n_views,
                              n_slices=n_slices, n_angles=20, dtype=dtype)
    k1, k2 = jax.random.split(jax.random.key(seed + 1))
    X0 = sc.X + 0.05 * jax.random.normal(k1, sc.X.shape, dtype)
    t0 = sc.t + 0.05 * jax.random.normal(k2, sc.t.shape, dtype)
    return sc.x.transpose(1, 0, 2), X0, sc.K, sc.R, t0


SYSTEM_CASES = {
    "plain": {},
    "huber": {"huber": 0.01},
    "radial": {"dist": 2},
    "opencv": {"dist": 4},
    "partial_visibility": {"vis": True},
}


@pytest.mark.parametrize("case", sorted(SYSTEM_CASES))
def test_chunked_system_matches_dense(case):
    """The chunked core's scan-accumulated (A, b) equals the dense core's
    Schur system (``_compute_derivs`` + ``reduced_camera_system``) in
    float64 — the same oracle chip_smoke.py uses on the card."""
    opts = SYSTEM_CASES[case]
    x, X0, K, R, t0 = _scene()
    state, free = chip_smoke._normalized_state(x, X0, K, R, t0)
    npts, nf = x.shape[:2]
    dt = x.dtype
    vis = jnp.ones((npts, nf), dt)
    if opts.get("vis"):
        rng = np.random.default_rng(0)
        vis = jnp.asarray(rng.uniform(size=(npts, nf)) > 0.3, dt)
    dist = model = None
    if "dist" in opts:
        dist = jnp.asarray(
            np.random.default_rng(1).normal(scale=0.02, size=(nf, opts["dist"])), dt
        )
        model = "radial" if opts["dist"] == 2 else "opencv"
    delta = opts.get("huber")
    c = 1e-2

    vis_d = vis if delta is None else _huber_weights(
        state, x, vis, 1.0, delta, dist, model)
    derivs, _ = _compute_derivs(state, x, vis_d, free, 1.0, None, dist, model)
    matEc = derivs.matE * (1.0 + c * jnp.eye(3, dtype=dt))
    matGc = derivs.matG * (1.0 + c * jnp.eye(9, dtype=dt))
    a_d, b_d, _ = reduced_camera_system(derivs, matEc, matGc, free)

    x_ch, vis_ch, X_ch = chunk_points(x, vis, state.X, 96)
    cam = state._replace(X=jnp.zeros((0, 3), dt))
    a_c, b_c, _, _ = _build_system(cam, X_ch, x_ch, vis_ch, free, 1.0, c,
                                   huber_delta=delta, dist=dist, model=model)
    np.testing.assert_allclose(np.asarray(a_c), np.asarray(a_d),
                               rtol=1e-9, atol=1e-9 * float(jnp.abs(a_d).max()))
    np.testing.assert_allclose(np.asarray(b_c * free), np.asarray(b_d),
                               rtol=1e-9, atol=1e-9 * float(jnp.abs(b_d).max()))


def test_chunk_points_pads_unseen_points_at_the_centroid():
    x = jnp.arange(10 * 3 * 2, dtype=jnp.float64).reshape(10, 3, 2)
    vis = jnp.ones((10, 1))
    X = jnp.arange(30, dtype=jnp.float64).reshape(10, 3)
    x_ch, vis_ch, X_ch = chunk_points(x, vis, X, 4)
    assert x_ch.shape == (3, 4, 3, 2) and vis_ch.shape == (3, 4, 1)
    assert X_ch.shape == (3, 4, 3)
    np.testing.assert_array_equal(np.asarray(vis_ch).reshape(-1)[10:], 0.0)
    np.testing.assert_allclose(np.asarray(X_ch).reshape(-1, 3)[10:],
                               np.broadcast_to(np.asarray(X).mean(0), (2, 3)))


def test_streamed_matches_chunked_synthetic():
    """The host-streamed core reproduces the chunked core (no oracle)."""
    from mvrecon_tpu.models.bundle_adjustment_streamed import bundle_adjust_streamed

    x, X0, K, R, t0 = _scene()
    cfg = LMConfig(scale_factor=2.0, delta_tol=1e-10, max_iter=5)
    kw = dict(f0=1.0, axis="x-up_z-forward", config=cfg, chunk_size=96)
    chunked = bundle_adjust_chunked(x, X0, K, R, t0, **kw)
    streamed = bundle_adjust_streamed(*(np.asarray(a) for a in (x, X0, K, R, t0)),
                                      **kw)
    np.testing.assert_allclose(float(streamed.error), float(chunked.error),
                               rtol=1e-9)
    assert int(streamed.n_iter) == int(chunked.n_iter)
    np.testing.assert_allclose(np.asarray(streamed.X), np.asarray(chunked.X),
                               atol=1e-9)


def test_dense_and_chunked_count_the_same_retries():
    x, X0, K, R, t0 = _scene()
    cfg = LMConfig(scale_factor=2.0, delta_tol=0.0, max_iter=6)
    kw = dict(f0=1.0, axis="x-up_z-forward", config=cfg)
    dense = bundle_adjust(x, X0, K, R, t0, **kw)
    chunked = bundle_adjust_chunked(x, X0, K, R, t0, chunk_size=96, **kw)
    assert int(dense.log["n_solver_retries"]) >= int(dense.n_iter)
    assert int(dense.log["n_solver_retries"]) == int(
        chunked.log["n_solver_retries"])


def test_sharded_bundle_adjust_reports_retries():
    from mvrecon_tpu.parallel.mesh import make_mesh
    from mvrecon_tpu.parallel.sharded_ba import sharded_bundle_adjust

    x, X0, K, R, t0 = _scene()
    cfg = LMConfig(scale_factor=2.0, delta_tol=0.0, max_iter=6)
    kw = dict(f0=1.0, axis="x-up_z-forward", config=cfg)
    dense = bundle_adjust(x, X0, K, R, t0, **kw)
    sharded = sharded_bundle_adjust(make_mesh({"points": 4}), x, X0, K, R, t0,
                                    **kw)
    assert int(sharded.log["n_solver_retries"]) == int(
        dense.log["n_solver_retries"])
    np.testing.assert_allclose(float(sharded.error), float(dense.error),
                               rtol=1e-8)


# --- compile cache ---------------------------------------------------------


@pytest.fixture
def cache_env(monkeypatch):
    from mvrecon_tpu.runtime import cache

    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    return cache, updates


def test_cache_honours_env_dir_exactly(cache_env, monkeypatch):
    cache, updates = cache_env
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/dir")
    cache.enable_compilation_cache()
    assert "jax_compilation_cache_dir" not in updates  # JAX reads the env


def test_cache_default_dir_is_fixed_inside_the_checkout(cache_env, monkeypatch):
    cache, updates = cache_env
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    cache.enable_compilation_cache()
    assert updates["jax_compilation_cache_dir"] == str(ROOT / ".jax_cache")
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


def test_cache_stays_off_on_cpu(cache_env, monkeypatch):
    cache, updates = cache_env
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert jax.default_backend() == "cpu"
    assert cache.enable_compilation_cache() is None
    assert updates == {}


# --- entry points without a GPU ---------------------------------------------


def test_chip_smoke_refuses_cpu_and_prints_no_ok_line():
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in out.getvalue()


def test_chip_smoke_last_line_contract():
    line = chip_smoke.ok_line({"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                               "count": 1, "extra": "ignored"})
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line


def test_bench_main_exits_without_gpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code not in (0, None)
    assert out.getvalue() == ""


def test_bench_headline_small_shapes():
    rec = bench.bench_headline(n_points=400, n_views=10)
    assert rec["points"] == 400 and rec["wall_s"] > 0
    assert np.isfinite(rec["reprojection_error"])
    line = bench.headline_record(rec)
    assert line["metric"] == "ba_400pts_10views_10iter_wall"
    assert line["vs_baseline"] == 0.0  # no reference wall at this shape


def test_bench_northstar_small_shapes():
    stats, (x, res) = bench.bench_northstar(n_points=2000, n_views=16,
                                            n_iters=3, chunk=512)
    assert stats["retries"] >= 3 and np.isfinite(stats["reprojection_error"])
    cov = bench.bench_covariance(x, res, chunk=512)
    assert np.isfinite(cov["sigma"])


def test_bench_bal_large_sparse_small_shapes():
    rec = bench.bench_bal_large(n_points=4000, n_cams=40, window=4)
    assert rec["n_iter"] >= 1 and np.isfinite(rec["aligned_rmse_vs_gt"])


# --- chip_smoke phases at small shapes on the CPU --------------------------


def test_chip_smoke_reference_phase_small():
    rec = chip_smoke.reference_phase(n_points=400, n_views=10, chunk=128)
    assert rec["A_rel_fro_err"] <= chip_smoke.SYSTEM_RTOL
    assert rec["rel_diff"] <= chip_smoke.LM_AGREE_RTOL


def test_chip_smoke_pipeline_phase_small():
    rec = chip_smoke.pipeline_phase(n_points=2000, n_views=16, chunk=512)
    assert rec["calib_status"] == 0


def test_chip_smoke_cli_phase_small():
    rec = chip_smoke.cli_phase(n_points=2000, n_cams=20)
    assert rec["rmse_vs_noise"] <= chip_smoke.CLI_RMSE_RATIO


def test_chip_smoke_four_cards_phase_on_virtual_devices():
    rec = chip_smoke.four_cards_phase(n_points=2000, n_views=16, chunk=512)
    assert rec["rel_diff_sharded_4"] <= chip_smoke.SHARDED_AGREE_RTOL
    assert rec["rel_diff_sharded_chunked_4"] <= chip_smoke.SHARDED_AGREE_RTOL


# --- runtime / CLI ------------------------------------------------------------


def test_initialize_passes_local_device_ids(monkeypatch):
    from mvrecon_tpu.runtime import distributed

    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: seen.update(kw))
    distributed.initialize("localhost:12345", 4, 2, local_device_ids=[2])
    assert seen == {"coordinator_address": "localhost:12345",
                    "num_processes": 4, "process_id": 2,
                    "local_device_ids": [2]}


def test_cli_platform_accepts_gpu_and_rejects_tpu():
    from mvrecon_tpu.cli import build_parser

    args = build_parser().parse_args(["euclidean", "--platform", "gpu"])
    assert args.platform == "gpu"
    with contextlib.redirect_stderr(io.StringIO()), pytest.raises(SystemExit):
        build_parser().parse_args(["euclidean", "--platform", "tpu"])


# --- SYRK kernel wrappers ----------------------------------------------------


def test_tri_ij_enumerates_the_lower_triangle():
    from mvrecon_tpu.ops.pallas_syrk import _tri_ij

    t = jnp.arange(141 * 142 // 2)  # every tile of a 9000-wide system
    i, j = (np.asarray(v) for v in _tri_ij(t))
    want_i, want_j = np.tril_indices(141)
    np.testing.assert_array_equal(i, want_i)
    np.testing.assert_array_equal(j, want_j)


def test_syrk_wrappers_use_the_einsum_off_gpu():
    from mvrecon_tpu.ops import pallas_syrk as ps

    y = jax.random.normal(jax.random.key(0), (48, 70), jnp.float32)
    hi = jax.lax.Precision.HIGHEST
    n_acc = ps.syrk_accumulator_dim(70, jnp.float32)
    acc = ps.syrk_lower_or_fallback(y, hi, n_acc)
    full = ps.finish_syrk_accumulator(acc, 70, jnp.float32)
    np.testing.assert_allclose(np.asarray(full),
                               np.asarray(ps.syrk_or_fallback(y, hi)))
    hlo = jax.jit(lambda y: ps.syrk_or_fallback(y, hi)).lower(y).as_text()
    assert "triton" not in hlo


def test_syrk_kernel_is_chosen_when_lowering_for_cuda():
    """The choice follows the platform being lowered for, not the
    process: the same function lowered for CUDA calls the Triton
    kernel, lowered for the CPU it does not; float64 never does."""
    from mvrecon_tpu.ops import pallas_syrk as ps

    hi = jax.lax.Precision.HIGHEST
    triton = "__gpu$xla.gpu.triton"

    def lowered(dtype, platform):
        y = jnp.ones((48, 300), dtype)
        f = jax.jit(lambda y: ps.finish_syrk_accumulator(
            ps.syrk_lower_or_fallback(y, hi, ps.syrk_accumulator_dim(300, dtype)),
            300, dtype))
        exp = jax.export.export(
            f, platforms=[platform],
            disabled_checks=[jax.export.DisabledSafetyCheck.custom_call(triton)],
        )(y)
        return exp.mlir_module()

    assert triton in lowered(jnp.float32, "cuda")
    assert triton not in lowered(jnp.float32, "cpu")
    assert triton not in lowered(jnp.float64, "cuda")


def test_syrk_accumulator_pads_float32_to_the_tile():
    from mvrecon_tpu.ops import pallas_syrk as ps

    assert ps.syrk_accumulator_dim(9000, jnp.float32) == 9088  # 71 x 128
    assert ps.syrk_accumulator_dim(9000, jnp.float64) == 9000


def test_syrk_kernel_builds_under_sharded_chunked_ba():
    """``sharded_bundle_adjust_chunked`` in float32 on the 8-device mesh.
    Lowered for CUDA, its shard_map holds the Triton kernel, whose output
    must carry the operand's varying mesh axis for ``check_vma``; both
    branches are traced on every platform, so the CPU run checks that too.
    Run here (einsum branch), it matches the one-device chunked core."""
    from functools import partial

    from mvrecon_tpu.parallel.mesh import make_mesh
    from mvrecon_tpu.parallel.sharded_ba import sharded_bundle_adjust_chunked

    x, X0, K, R, t0 = _scene(n_views=6, n_slices=16, dtype=jnp.float32)
    cfg = LMConfig(scale_factor=2.0, delta_tol=0.0, max_iter=4)
    kw = dict(f0=1.0, axis="x-up_z-forward", config=cfg, chunk_size=24)
    sharded = jax.jit(partial(sharded_bundle_adjust_chunked,
                              make_mesh({"points": 8}), **kw))
    got = sharded(x, X0, K, R, t0)
    want = bundle_adjust_chunked(x, X0, K, R, t0, **kw)
    assert int(got.log["n_solver_retries"]) == int(want.log["n_solver_retries"])
    np.testing.assert_allclose(float(got.error), float(want.error), rtol=1e-4)

    triton = "__gpu$xla.gpu.triton"
    exp = jax.export.export(
        sharded, platforms=["cuda"],
        disabled_checks=[jax.export.DisabledSafetyCheck.custom_call(triton)],
    )(x, X0, K, R, t0)
    assert triton in exp.mlir_module()


def test_syrk_lower_accumulates_then_mirrors_once():
    """Summing per-chunk lower-tile partials and mirroring once (the
    chunked scan's use) equals the sum of the Y^T Y products."""
    from mvrecon_tpu.ops.pallas_syrk import mirror_lower, syrk_lower

    ys = jax.random.normal(jax.random.key(3), (3, 40, 150), jnp.float32)
    acc = sum(syrk_lower(y, tile_n=64, tile_k=16, interpret=True) for y in ys)
    got = mirror_lower(acc, 150, tile_n=64)
    want = sum(y.T @ y for y in np.asarray(ys, np.float64))
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-5, atol=1e-4)
