"""Elastic execution: host-side retries + crash-resumable segmented runs.

The reference has no failure story beyond raising ValueError (SURVEY.md
§5); in-graph failures here are already status flags / graceful
never-accepted LM stops. This module adds the *host-side* half for long
production runs:

- :func:`run_with_retries` — re-execute a flaky device call (e.g. on a
  preempted host) with bounded attempts;
- :func:`resumable_bundle_adjust` — segmented chunked BA whose full state
  (X, K, R, t, damping c/nu, completed iterations) is checkpointed after
  every segment; a re-invocation after a crash/preemption finds the
  checkpoint and continues exactly where the dead process stopped
  (segmented == continuous is pinned by the chunked-core resume tests).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable

import numpy as np

import jax.numpy as jnp

from ..config import LMConfig
from .checkpoint import checkpoint_backend


def run_with_retries(
    fn: Callable,
    max_attempts: int = 3,
    retry_on: tuple = (RuntimeError,),
    backoff_s: float = 1.0,
    on_retry: Callable[[int, Exception], None] | None = None,
):
    """Call ``fn()``; on an exception in ``retry_on`` wait and re-call, up
    to ``max_attempts`` total. Raises the last error if all attempts fail."""
    last = None
    for attempt in range(max_attempts):
        try:
            return fn()
        except retry_on as e:  # noqa: PERF203
            last = e
            if on_retry is not None:
                on_retry(attempt, e)
            if attempt + 1 < max_attempts:
                time.sleep(backoff_s * (2**attempt))
    raise last


def resumable_bundle_adjust(
    x,
    init_X,
    init_K,
    init_R,
    init_t,
    checkpoint_path: str,
    total_iters: int,
    segment_iters: int = 5,
    f0: float = 1.0,
    visibility=None,
    axis: str = "x-right_z-forward",
    config: LMConfig = LMConfig(),
    chunk_size: int = 768,
    backend: str = "npz",
    distortion=None,
):
    """Chunked BA in checkpointed segments; safe to kill and re-invoke.

    If ``checkpoint_path`` exists, optimization resumes from its saved
    (X, K, R, t, c, nu, done) instead of ``init_*``. Returns the final
    BAResult plus the number of iterations actually run in this process.
    ``backend`` selects the persistence format: "npz" (single file) or
    "orbax" (checkpoint directory; see ``runtime/checkpoint.py``).

    ``distortion``: a *fixed* (F, 2) BAL radial model, applied in every
    segment (the caller passes the same value on re-invocation, so it is
    not checkpointed). The refit alternation (``distortion_rounds > 0``)
    is schedule-dependent — its refit points would shift with the
    segment boundaries, breaking the segmented == continuous contract —
    so it is rejected here: run ``fit_distortion`` beforehand or use the
    continuous cores for alternated runs.
    """
    from ..models.bundle_adjustment_chunked import bundle_adjust_chunked

    if config.distortion_rounds > 0:
        raise ValueError(
            "resumable_bundle_adjust does not support the distortion refit "
            "alternation (distortion_rounds > 0): refits would move with "
            "the segment boundaries. Pass a fixed `distortion` instead."
        )

    save_ckpt, load_ckpt, ckpt_exists = checkpoint_backend(backend)
    state = {
        "X": np.asarray(init_X),
        "K": np.asarray(init_K),
        "R": np.asarray(init_R),
        "t": np.asarray(init_t),
        "c": np.asarray(config.init_damping, np.float64),
        "nu": np.asarray(2.0, np.float64),
    }
    done = 0
    if ckpt_exists(checkpoint_path):
        state, step = load_ckpt(checkpoint_path, state)
        state = {k: np.asarray(v) for k, v in state.items()}
        done = int(step or 0)

    ran_here = 0
    res = None
    while done < total_iters:
        seg = min(segment_iters, total_iters - done)
        # replace() keeps every other LMConfig field — a field-by-field
        # copy here silently dropped new fields as they were added.
        seg_cfg = dataclasses.replace(config, max_iter=seg)
        res = bundle_adjust_chunked(
            x, jnp.asarray(state["X"]), jnp.asarray(state["K"]),
            jnp.asarray(state["R"]), jnp.asarray(state["t"]),
            f0=f0, visibility=visibility, axis=axis, config=seg_cfg,
            chunk_size=chunk_size,
            init_c=jnp.asarray(state["c"]), init_nu=jnp.asarray(state["nu"]),
            distortion=distortion,
        )
        n = int(res.n_iter)
        ran_here += n
        done += n
        state = {
            "X": np.asarray(res.X), "K": np.asarray(res.K),
            "R": np.asarray(res.R), "t": np.asarray(res.t),
            "c": np.asarray(res.log["c"], np.float64),
            "nu": np.asarray(res.log["nu"], np.float64),
        }
        save_ckpt(checkpoint_path, state, step=done)
        if n < seg:
            break  # converged (delta_tol) or gracefully stopped
    return res, ran_here


def resumable_bundle_adjust_sparse(
    obs,
    init_X,
    init_K,
    init_R,
    init_t,
    checkpoint_path: str,
    total_iters: int,
    segment_iters: int = 1,
    f0: float = 1.0,
    axis: str = "x-right_z-forward",
    config: LMConfig = LMConfig(),
    cg_tol: float = 1e-2,
    cg_max_iter: int = 100,
    obs_chunk: int = 1 << 16,
    backend: str = "npz",
    distortion=None,
    factor_dtype: str | None = None,
    matvec_chunk: int | None = None,
    factor_mode: str = "stored",
    on_segment=None,
):
    """Observation-list BA in checkpointed segments — the sparse twin of
    :func:`resumable_bundle_adjust` (same kill-and-reinvoke contract,
    same exact-trajectory guarantee via the ``init_c``/``init_nu``
    damping carry and the gauge-roundtrip identity).

    Besides crash resilience, segmenting BOUNDS THE WORK PER DEVICE
    EXECUTION: one segment is one jit call, so schedulers that cap a
    single execution's wall run arbitrarily large solves as a sequence
    of bounded calls; every segment after the first reuses the compiled
    executable.
    ``on_segment(done, res)`` is called after each segment (progress /
    watchdog petting)."""
    from ..models.bundle_adjustment_sparse import bundle_adjust_sparse

    if config.distortion_rounds > 0:
        raise ValueError(
            "resumable_bundle_adjust_sparse does not support the "
            "distortion refit alternation (see resumable_bundle_adjust); "
            "pass a fixed `distortion` instead."
        )

    save_ckpt, load_ckpt, ckpt_exists = checkpoint_backend(backend)
    state = {
        "X": np.asarray(init_X),
        "K": np.asarray(init_K),
        "R": np.asarray(init_R),
        "t": np.asarray(init_t),
        "c": np.asarray(config.init_damping, np.float64),
        "nu": np.asarray(2.0, np.float64),
    }
    done = 0
    if ckpt_exists(checkpoint_path):
        state, step = load_ckpt(checkpoint_path, state)
        state = {k: np.asarray(v) for k, v in state.items()}
        done = int(step or 0)

    ran_here = 0
    res = None
    while done < total_iters:
        seg = min(segment_iters, total_iters - done)
        seg_cfg = dataclasses.replace(config, max_iter=seg)
        res = bundle_adjust_sparse(
            obs, jnp.asarray(state["X"]), jnp.asarray(state["K"]),
            jnp.asarray(state["R"]), jnp.asarray(state["t"]),
            f0=f0, axis=axis, config=seg_cfg,
            cg_tol=cg_tol, cg_max_iter=cg_max_iter, obs_chunk=obs_chunk,
            init_c=jnp.asarray(state["c"]), init_nu=jnp.asarray(state["nu"]),
            distortion=distortion, factor_dtype=factor_dtype,
            matvec_chunk=matvec_chunk, factor_mode=factor_mode,
        )
        n = int(res.n_iter)
        ran_here += n
        done += n
        state = {
            "X": np.asarray(res.X), "K": np.asarray(res.K),
            "R": np.asarray(res.R), "t": np.asarray(res.t),
            "c": np.asarray(res.log["c"], np.float64),
            "nu": np.asarray(res.log["nu"], np.float64),
        }
        save_ckpt(checkpoint_path, state, step=done)
        if on_segment is not None:
            on_segment(done, res)
        # stop on the core's own |dE| <= delta_tol / never-accepted flag:
        # with segment_iters == 1, n == seg ALWAYS (the stopping
        # iteration still counts), so n < seg alone would drive the
        # solve arbitrarily far past convergence — where Nielsen damping
        # has shrunk to ~1e-7 and IRLS re-weighting lets near-undamped
        # steps blow the state up (measured: E 4.6 -> NaN by segment 20
        # at 4k x 40).
        if n < seg or bool(res.log["converged"]):
            break
    return res, ran_here
