"""Fault injection + elastic recovery (SURVEY §5 failure-detection row):
divergence must be survived end-to-end in every execution regime, and a
killed long run must resume from its checkpoint."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mvrecon_tpu.config import LMConfig
from mvrecon_tpu.models.bundle_adjustment import bundle_adjust
from mvrecon_tpu.models.bundle_adjustment_chunked import bundle_adjust_chunked

from conftest import make_ref_scene


def _ba_problem(ref, quiet, nf=12):
    _, _, _, _, x_list = make_ref_scene(ref, n_images=nf)
    with quiet():
        X_, R_ = ref.affine.paraperspective_self_calibration(
            [x.copy() for x in x_list], np.ones(nf)
        )
    t_ = -3 * R_[:, :, 2]
    K_ = np.broadcast_to(np.eye(3), R_.shape).copy()
    x = np.stack(x_list).transpose(1, 0, 2)
    return x, X_, K_, R_, t_


def test_nan_observations_dense_graceful(ref, quiet):
    """NaN observations: the never-accepted retry path must freeze the
    state (no crash, no NaN state) instead of the reference's infinite
    retry loop."""
    x, X_, K_, R_, t_ = _ba_problem(ref, quiet)
    x = x.copy()
    x[3, 2, 0] = np.nan  # unmasked corruption
    res = bundle_adjust(
        jnp.asarray(x), jnp.asarray(X_), jnp.asarray(K_), jnp.asarray(R_),
        jnp.asarray(t_), axis="x-up_z-forward",
        config=LMConfig(scale_factor=2.0, delta_tol=1e-10, max_iter=5),
    )
    # state frozen at the init (every step rejected); parameters stay finite
    assert np.isfinite(np.asarray(res.X)).all()
    assert np.isfinite(np.asarray(res.R)).all()


def test_nan_observations_masked_are_harmless(ref, quiet):
    """The same corruption behind a visibility 0 must not perturb the
    result at all (0 * nan guard)."""
    x, X_, K_, R_, t_ = _ba_problem(ref, quiet)
    cfg = LMConfig(scale_factor=2.0, delta_tol=1e-10, max_iter=6)
    vis = np.ones(x.shape[:2])
    clean = bundle_adjust_chunked(
        jnp.asarray(x), jnp.asarray(X_), jnp.asarray(K_), jnp.asarray(R_),
        jnp.asarray(t_), visibility=jnp.asarray(vis), axis="x-up_z-forward",
        config=cfg, chunk_size=64,
    )
    x2 = x.copy()
    vis2 = vis.copy()
    x2[3, 2, :] = np.nan
    vis2[3, 2] = 0.0
    masked = bundle_adjust_chunked(
        jnp.asarray(x2), jnp.asarray(X_), jnp.asarray(K_), jnp.asarray(R_),
        jnp.asarray(t_), visibility=jnp.asarray(vis2), axis="x-up_z-forward",
        config=cfg, chunk_size=64,
    )
    assert np.isfinite(float(masked.error))
    # one hidden observation out of 2400: results near-identical
    np.testing.assert_allclose(np.asarray(masked.X), np.asarray(clean.X), atol=1e-3)


def test_batched_fault_isolation(ref):
    """One poisoned scene in a vmapped batch must not contaminate the
    others (per-scene status/error isolation)."""
    from mvrecon_tpu.parallel.batched import batched_euclidean_reconstruction

    scenes = []
    for seed in (123, 7, 99):
        _, _, _, _, x_list = make_ref_scene(ref, n_images=6, seed=seed)
        scenes.append(np.stack(x_list))
    x = np.stack(scenes)
    x[1, :, :, :] = np.nan  # kill scene 1 entirely
    res = batched_euclidean_reconstruction(
        jnp.asarray(x), f0=1.0, tol=1e-2, method="dual",
        config=LMConfig(scale_factor=2.0, delta_tol=1e-8, max_iter=15),
    )
    errs = np.asarray(res.error)
    noise_floor = 200 * 6 * 2 * (0.005**2)
    assert np.isfinite(errs[0]) and errs[0] < 5 * noise_floor
    assert np.isfinite(errs[2]) and errs[2] < 5 * noise_floor
    assert not np.isfinite(errs[1])  # the poisoned scene is flagged, not hidden


def test_sharded_fault_graceful(ref, quiet):
    """NaN inside one point-shard: the sharded LM must stop gracefully
    with finite camera state on every device."""
    from mvrecon_tpu.parallel.mesh import make_mesh
    from mvrecon_tpu.parallel.sharded_ba import sharded_bundle_adjust

    x, X_, K_, R_, t_ = _ba_problem(ref, quiet)
    x = x.copy()
    x[7, 1, 1] = np.inf
    mesh = make_mesh({"points": 4})
    res = sharded_bundle_adjust(
        mesh, jnp.asarray(x), jnp.asarray(X_), jnp.asarray(K_),
        jnp.asarray(R_), jnp.asarray(t_), axis="x-up_z-forward",
        config=LMConfig(scale_factor=2.0, delta_tol=1e-10, max_iter=4),
    )
    assert np.isfinite(np.asarray(res.R)).all()
    assert np.isfinite(np.asarray(res.t)).all()


def test_resumable_bundle_adjust_survives_crash(tmp_path):
    """Kill-and-reinvoke: a fresh resumable run that finds the checkpoint
    continues to the same final state as an uninterrupted run. (Uses a
    synthetic scene with a well-conditioned gauge: the affine heuristic
    init has t1_y near zero, where the gauge sign convention — the
    reference's np.sign at bundle_adjustment.py:227-238 — can flip the
    frame between otherwise-identical runs.)"""
    from mvrecon_tpu.geometry.scenes import make_synthetic_scene
    from mvrecon_tpu.runtime.elastic import resumable_bundle_adjust

    scene = make_synthetic_scene(jax.random.key(2), n_images=12)
    X_ = scene.X + 0.02 * jax.random.normal(jax.random.key(3), scene.X.shape,
                                            scene.X.dtype)
    K_, R_, t_ = scene.K, scene.R, scene.t
    xj = scene.x.transpose(1, 0, 2)
    cfg = LMConfig(scale_factor=2.0, delta_tol=0.0, max_iter=99)
    ck = str(tmp_path / "elastic.npz")

    full, n_full = resumable_bundle_adjust(
        xj, X_, K_, R_, t_, str(tmp_path / "full.npz"), total_iters=6,
        segment_iters=6, axis="x-up_z-forward", config=cfg, chunk_size=64,
    )
    assert n_full == 6

    # "crashed" process: completed only the first 3-iteration segment
    part, n1 = resumable_bundle_adjust(
        xj, X_, K_, R_, t_, ck, total_iters=3, segment_iters=3,
        axis="x-up_z-forward", config=cfg, chunk_size=64,
    )
    assert n1 == 3 and os.path.exists(ck)
    # restarted process: finds the checkpoint, runs only the remainder
    resumed, n2 = resumable_bundle_adjust(
        xj, X_, K_, R_, t_, ck, total_iters=6, segment_iters=3,
        axis="x-up_z-forward", config=cfg, chunk_size=64,
    )
    assert n2 == 3
    np.testing.assert_allclose(float(resumed.error), float(full.error), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(resumed.X), np.asarray(full.X), atol=1e-9)


def test_resumable_preserves_config_and_distortion(tmp_path):
    """Segment configs are built with dataclasses.replace, so every
    LMConfig field (here: huber robust + nielsen damping) survives into
    the segments; a fixed BAL distortion passes through; and the
    schedule-dependent refit alternation is rejected with a clear error
    (a field-by-field copy previously dropped new fields silently)."""
    import pytest

    from mvrecon_tpu.geometry.scenes import make_synthetic_scene
    from mvrecon_tpu.models.bundle_adjustment_chunked import (
        bundle_adjust_chunked,
    )
    from mvrecon_tpu.runtime.elastic import resumable_bundle_adjust

    scene = make_synthetic_scene(jax.random.key(2), n_images=8)
    X_ = scene.X + 0.02 * jax.random.normal(jax.random.key(3), scene.X.shape,
                                            scene.X.dtype)
    xj = scene.x.transpose(1, 0, 2)
    nf = scene.x.shape[0]
    dist = jnp.full((nf, 2), jnp.asarray([-0.1, 0.02]), scene.X.dtype)
    cfg = LMConfig(delta_tol=0.0, max_iter=99, damping="nielsen",
                   robust="huber", huber_delta=0.05)

    direct = bundle_adjust_chunked(
        xj, X_, scene.K, scene.R, scene.t, axis="x-up_z-forward",
        config=LMConfig(delta_tol=0.0, max_iter=4, damping="nielsen",
                        robust="huber", huber_delta=0.05),
        chunk_size=64, distortion=dist,
    )
    seg, n = resumable_bundle_adjust(
        xj, X_, scene.K, scene.R, scene.t, str(tmp_path / "d.npz"),
        total_iters=4, segment_iters=2, axis="x-up_z-forward", config=cfg,
        chunk_size=64, distortion=dist,
    )
    assert n == 4
    np.testing.assert_allclose(float(seg.error), float(direct.error), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(seg.X), np.asarray(direct.X),
                               atol=1e-9)

    with pytest.raises(ValueError, match="distortion_rounds"):
        resumable_bundle_adjust(
            xj, X_, scene.K, scene.R, scene.t, str(tmp_path / "e.npz"),
            total_iters=4, config=LMConfig(distortion_rounds=1),
        )


def test_run_with_retries():
    from mvrecon_tpu.runtime.elastic import run_with_retries

    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("transient")
        return "ok"

    assert run_with_retries(flaky, max_attempts=4, backoff_s=0.0) == "ok"
    assert len(calls) == 3

    with pytest.raises(RuntimeError):
        run_with_retries(lambda: (_ for _ in ()).throw(RuntimeError("x")),
                         max_attempts=2, backoff_s=0.0)


def test_watchdog_fires_on_stall_and_not_on_progress():
    """The progress watchdog must fire when nothing pets it within the
    deadline (simulated wedged device call) and stay silent while progress
    is reported. on_timeout is overridden — the production default would
    dump stacks and exit 124."""
    import time

    from mvrecon_tpu.runtime.watchdog import Watchdog

    fired = []
    with Watchdog(timeout_s=0.2, on_timeout=lambda e: fired.append(e),
                  poll_s=0.05) as dog:
        time.sleep(0.6)  # the "wedge": no pet within the deadline
    assert dog.fired and len(fired) == 1 and fired[0] >= 0.2

    fired2 = []
    with Watchdog(timeout_s=0.5, on_timeout=lambda e: fired2.append(e),
                  poll_s=0.05) as dog2:
        for _ in range(4):
            time.sleep(0.2)
            dog2.pet()  # steady progress: deadline never elapses
    assert not dog2.fired and not fired2


def test_watchdog_aborts_wedged_process():
    """End-to-end: a subprocess whose 'device call' never returns is
    killed by the watchdog with exit code 124 (the resume signal for a
    supervising loop)."""
    import subprocess
    import sys as _sys

    code = (
        "from mvrecon_tpu.runtime.watchdog import Watchdog\n"
        "import time\n"
        "with Watchdog(timeout_s=0.3, poll_s=0.05):\n"
        "    time.sleep(30)\n"  # wedged forever (relative to the deadline)
    )
    proc = subprocess.run(
        [_sys.executable, "-c", code], capture_output=True, timeout=20,
        text=True, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert proc.returncode == 124
    assert "watchdog" in proc.stderr


def test_supervised_restart_resumes_after_wedge(tmp_path):
    """Full resilience loop: a run whose device call wedges mid-job is
    killed by the watchdog (exit 124), the supervisor re-invokes, and the
    restarted run resumes from the checkpoint to exactly the result of an
    uninterrupted run. This is the contract documented in
    docs/SCALING.md's supervised-restart recipe."""
    import subprocess
    import sys as _sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ck = str(tmp_path / "wedge_ck.npz")
    out = str(tmp_path / "result.npz")

    script = r"""
import sys, time
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp

wedge = sys.argv[1] == "wedge"
ck, out = sys.argv[2], sys.argv[3]

from mvrecon_tpu.config import LMConfig
from mvrecon_tpu.geometry.scenes import make_synthetic_scene
from mvrecon_tpu.runtime.elastic import resumable_bundle_adjust
from mvrecon_tpu.runtime.watchdog import Watchdog
import mvrecon_tpu.runtime.elastic as elastic

scene = make_synthetic_scene(jax.random.key(2), n_images=12)
X0 = scene.X + 0.02 * jax.random.normal(jax.random.key(3), scene.X.shape,
                                        scene.X.dtype)
xj = scene.x.transpose(1, 0, 2)
cfg = LMConfig(scale_factor=2.0, delta_tol=0.0, max_iter=99)

if wedge:
    # simulate a device link that wedges after the first segment: the
    # second bundle_adjust_chunked call never returns. The watchdog is
    # armed *at the wedge* so legitimate first-segment compile time
    # (arbitrarily slow under CI load) cannot race the deadline.
    from mvrecon_tpu.models import bundle_adjustment_chunked as bac
    real = bac.bundle_adjust_chunked
    calls = {"n": 0}
    def wedging(*a, **k):
        calls["n"] += 1
        if calls["n"] >= 2:
            Watchdog(timeout_s=3.0, poll_s=0.25).start()
            time.sleep(600)  # "stuck in a device RPC"
        return real(*a, **k)
    # resumable_bundle_adjust imports the symbol at call time
    bac.bundle_adjust_chunked = wedging

res, n = resumable_bundle_adjust(
    xj, X0, scene.K, scene.R, scene.t, checkpoint_path=ck,
    total_iters=6, segment_iters=2, axis="x-up_z-forward",
    config=cfg, chunk_size=64,
)
np.savez(out, X=np.asarray(res.X), e=float(res.error), n=n)
print("COMPLETED", n)
"""
    # 1st invocation wedges after one segment -> watchdog exit 124
    p1 = subprocess.run(
        [_sys.executable, "-c", script, "wedge", ck, out],
        capture_output=True, text=True, timeout=300, cwd=repo,
    )
    assert p1.returncode == 124, (p1.returncode, p1.stderr[-400:])
    assert os.path.exists(ck), "first segment must have checkpointed"
    assert not os.path.exists(out)

    # supervisor restarts -> resumes from the checkpoint and completes
    p2 = subprocess.run(
        [_sys.executable, "-c", script, "clean", ck, out],
        capture_output=True, text=True, timeout=300, cwd=repo,
    )
    assert p2.returncode == 0, p2.stderr[-400:]
    resumed = np.load(out)
    assert int(resumed["n"]) < 6  # only the remainder ran here

    # uninterrupted oracle
    ck2, out2 = str(tmp_path / "full_ck.npz"), str(tmp_path / "full.npz")
    p3 = subprocess.run(
        [_sys.executable, "-c", script, "clean", ck2, out2],
        capture_output=True, text=True, timeout=300, cwd=repo,
    )
    assert p3.returncode == 0, p3.stderr[-400:]
    full = np.load(out2)
    np.testing.assert_allclose(float(resumed["e"]), float(full["e"]), rtol=1e-9)
    np.testing.assert_allclose(resumed["X"], full["X"], atol=1e-9)


def test_resumable_sparse_matches_continuous(tmp_path):
    """The sparse twin (round 5: also the bounded-execution driver for
    environments that kill long device calls): 1-iteration segments with
    kill-and-reinvoke reach exactly the continuous run's state."""
    from mvrecon_tpu.geometry.scenes import make_synthetic_scene
    from mvrecon_tpu.models.bundle_adjustment_sparse import (
        bundle_adjust_sparse, dense_to_sparse_obs,
    )
    from mvrecon_tpu.runtime.elastic import resumable_bundle_adjust_sparse

    scene = make_synthetic_scene(jax.random.key(2), n_images=10)
    X_ = scene.X + 0.02 * jax.random.normal(jax.random.key(3), scene.X.shape,
                                            scene.X.dtype)
    xj = scene.x.transpose(1, 0, 2)
    rng = np.random.default_rng(0)
    vis = (rng.random(xj.shape[:2]) < 0.6).astype(np.float64)
    obs = dense_to_sparse_obs(np.asarray(xj), vis)
    cfg = LMConfig(scale_factor=4.0, delta_tol=0.0, max_iter=99,
                   accept_divisor=1.0, init_damping=3e-3, damping="nielsen")
    kw = dict(f0=1.0, axis="x-up_z-forward", config=cfg,
              cg_tol=1e-12, cg_max_iter=500)

    cont = bundle_adjust_sparse(
        obs, X_, scene.K, scene.R, scene.t,
        **{**kw, "config": LMConfig(**{**cfg.__dict__, "max_iter": 5})},
    )
    segs = []

    seg, n1 = resumable_bundle_adjust_sparse(
        obs, X_, scene.K, scene.R, scene.t,
        str(tmp_path / "sp.npz"), total_iters=2, segment_iters=1,
        on_segment=lambda done, res: segs.append(done), **kw,
    )
    assert n1 == 2 and segs == [1, 2]
    resumed, n2 = resumable_bundle_adjust_sparse(
        obs, X_, scene.K, scene.R, scene.t,
        str(tmp_path / "sp.npz"), total_iters=5, segment_iters=1, **kw,
    )
    assert n2 == 3
    np.testing.assert_allclose(float(resumed.error), float(cont.error),
                               rtol=1e-9)
    np.testing.assert_allclose(np.asarray(resumed.X), np.asarray(cont.X),
                               atol=1e-8)
