"""Scene-batched (data-parallel) reconstruction.

The BASELINE north star: 256 scenes x 100 views of factorization + BA
batched over the devices. Each scene is an independent reconstruction;
``vmap`` turns every per-scene SVD/eigh/einsum into its batched form
(large batched matmuls on one device), and sharding the leading ``scenes``
axis over the mesh scales across devices — the collectives-free pure-DP regime.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import LMConfig
from ..models.pipelines import (
    ReconstructionResult,
    affine_reconstruction,
    euclidean_reconstruction,
)

SCENES_AXIS = "scenes"


@partial(jax.jit, static_argnames=("model", "f0", "config", "scene_chunk"))
def batched_affine_reconstruction(
    x: jax.Array,
    f: jax.Array,
    model: str = "paraperspective",
    f0: float = 1.0,
    config: LMConfig = LMConfig(scale_factor=2.0, delta_tol=1e-8, max_iter=100),
    scene_chunk: int | None = None,
) -> ReconstructionResult:
    """vmap the affine pipeline over a leading scenes axis:
    x (S, F, P, 2), f (S, F). ``scene_chunk``: see the euclidean variant."""
    fn = partial(affine_reconstruction, model=model, f0=f0, config=config)
    if scene_chunk is None:
        return jax.vmap(fn)(x, f)
    return jax.lax.map(lambda args: fn(*args), (x, f), batch_size=scene_chunk)


@partial(
    jax.jit,
    static_argnames=("method", "f0", "tol", "config", "eig_method", "scene_chunk"),
)
def batched_euclidean_reconstruction(
    x: jax.Array,
    f0: float = 1.0,
    tol: float = 1e-2,
    method: str = "dual",
    config: LMConfig = LMConfig(scale_factor=2.0, delta_tol=1e-8, max_iter=100),
    eig_method: str = "eigh",
    scene_chunk: int | None = None,
) -> ReconstructionResult:
    """vmap the perspective pipeline over a leading scenes axis:
    x (S, F, P, 2).

    ``scene_chunk`` streams the batch through HBM in blocks of that many
    scenes (lax.map batch_size: vmap within a block, scan over blocks) —
    one chip can then process arbitrarily many scenes at a fixed memory
    footprint. Unset = pure vmap (all scenes resident)."""
    fn = partial(euclidean_reconstruction, f0=f0, tol=tol, method=method,
                 config=config, eig_method=eig_method)
    if scene_chunk is None:
        return jax.vmap(fn)(x)
    return jax.lax.map(fn, x, batch_size=scene_chunk)


def shard_scenes(x: jax.Array, mesh: Mesh) -> jax.Array:
    """Place a (S, ...) batch with the scenes axis sharded over the mesh —
    XLA then runs the batched pipeline pure-DP with zero collectives."""
    return jax.device_put(x, NamedSharding(mesh, P(SCENES_AXIS)))


def _bucket(n: int) -> int:
    """Round a compaction-subset size up to a small set of bucket sizes so
    continuation phases reuse compiled programs instead of recompiling per
    distinct subset size."""
    b = 8
    while b < n:
        b *= 2
    return b


def batched_euclidean_to_convergence(
    x: jax.Array,
    f0: float = 1.0,
    tol: float = 1e-2,
    method: str = "dual",
    config: LMConfig = LMConfig(scale_factor=2.0, delta_tol=1e-3, max_iter=15),
    eig_method: str = "lowrank",
    scene_chunk: int | None = None,
    continuation_budget: int = 25,
    max_phases: int = 8,
    carry_damping: bool = True,
) -> ReconstructionResult:
    """Run every scene to the reference stopping contract (per-scene
    |dE| <= config.delta_tol) via **scene compaction**: a vmapped
    ``while_loop`` cannot stop paying for converged lanes (each chunk
    runs to its slowest scene), so after the first fixed-budget pipeline
    pass the still-unconverged scenes are gathered into a small batch
    and continued with BA-only phases until all reach the tolerance (or
    ``max_phases`` expires). Subset sizes round up to power-of-two
    buckets so continuation programs compile once per bucket, not per
    subset.

    ``carry_damping`` resumes each scene's Nielsen (c, nu) across phases
    (the per-scene damping state rides ``ba_log``), so the compacted
    trajectory IS the continuous one — round 3 measured compaction
    losing (15.1 vs 8.6 s) precisely because per-phase damping restarts
    re-paid rejected retries on near-converged scenes; False restores
    that behavior for comparison.

    Returns the merged per-scene results; ``n_iter`` counts TOTAL BA
    iterations across phases, and scenes still at the budget after
    ``max_phases`` keep ``n_iter == sum of budgets`` (inspect it to see
    who hit the cap). Reference contract:
    ``/root/reference/lib/bundle_adjustment.py:186-191``.
    """
    from ..models.bundle_adjustment import bundle_adjust

    if config.delta_tol <= 0:
        raise ValueError("to-convergence mode needs config.delta_tol > 0")

    res = batched_euclidean_reconstruction(
        x, f0=f0, tol=tol, method=method, config=config,
        eig_method=eig_method, scene_chunk=scene_chunk,
    )
    X = np.array(res.X)
    K = np.array(res.K)
    R = np.array(res.R)
    t = np.array(res.t)
    err = np.array(res.error)
    n_iter = np.array(res.n_iter)
    status = np.asarray(res.status)
    c_arr = np.array(res.ba_log["c"])
    nu_arr = np.array(res.ba_log["nu"])
    x_pf = np.asarray(x).transpose(0, 2, 1, 3)  # (S, P, F, 2)

    import dataclasses

    cont_cfg = dataclasses.replace(config, max_iter=continuation_budget)

    @partial(jax.jit, static_argnames=())
    def _continue(x_b, X_b, K_b, R_b, t_b, c_b, nu_b):
        def one(x1, X1, K1, R1, t1, c1, nu1):
            r = bundle_adjust(
                x1, X1, K1, R1, t1, f0=f0, axis="x-up_z-forward",
                config=cont_cfg,
                init_c=c1 if carry_damping else None,
                init_nu=nu1 if carry_damping else None,
            )
            return (r.X, r.K, r.R, r.t, r.error, r.n_iter,
                    r.log["c"], r.log["nu"])

        return jax.vmap(one)(x_b, X_b, K_b, R_b, t_b, c_b, nu_b)

    # A phase that stops before exhausting its budget converged (the
    # per-lane while_loop only exits early on |dE| <= delta_tol or a
    # graceful never-accepted stop). Tracking this explicitly avoids the
    # n_iter-modulo aliasing of treating "landed on a budget multiple"
    # as unconverged; a scene that converges on exactly its last
    # budgeted iteration costs at most one short confirmation phase.
    active = (n_iter == config.max_iter) & np.isfinite(err)
    for _ in range(max_phases):
        unconverged = np.nonzero(active)[0]
        if len(unconverged) == 0:
            break
        m = _bucket(len(unconverged))
        idx = np.concatenate(
            [unconverged, np.full(m - len(unconverged), unconverged[0])]
        )
        outs = _continue(
            jnp.asarray(x_pf[idx]), jnp.asarray(X[idx]), jnp.asarray(K[idx]),
            jnp.asarray(R[idx]), jnp.asarray(t[idx]),
            jnp.asarray(c_arr[idx]), jnp.asarray(nu_arr[idx]),
        )
        Xn, Kn, Rn, tn, en, nin, cn, nun = (np.asarray(o) for o in outs)
        k = len(unconverged)
        X[unconverged] = Xn[:k]
        K[unconverged] = Kn[:k]
        R[unconverged] = Rn[:k]
        t[unconverged] = tn[:k]
        err[unconverged] = en[:k]
        n_iter[unconverged] += nin[:k]
        c_arr[unconverged] = cn[:k]
        nu_arr[unconverged] = nun[:k]
        active[unconverged] = (
            (nin[:k] == continuation_budget) & np.isfinite(en[:k])
        )

    return ReconstructionResult(
        X=jnp.asarray(X), K=jnp.asarray(K), R=jnp.asarray(R), t=jnp.asarray(t),
        error=jnp.asarray(err), n_iter=jnp.asarray(n_iter),
        calib_X=res.calib_X, status=jnp.asarray(status),
    )
