"""Wall-time decomposition of the sparse BA core at BAL scale.

Decides whether a Pallas sorted-segment-sum kernel is warranted
(round-4 lead): times the damped system build, one Schur matvec, and a
full LM step separately, so the camera-segment-sum share is visible.
If matvecs dominate (CG iters x matvec >> build), the segment reductions
inside `_schur_matvec` are the kernel target; if the build dominates,
the `_camera_blocks_scan` outer-product accumulation is.

Usage: python scripts/profile_bal_sparse.py [n_points] [n_cams] [window]
Prints one JSON line.
"""

import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")

from mvrecon_tpu.runtime.cache import enable_compilation_cache

enable_compilation_cache()

import jax
import jax.numpy as jnp

from mvrecon_tpu.config import LMConfig
from mvrecon_tpu.models.bundle_adjustment import BAState, gauge_mask
from mvrecon_tpu.models import bundle_adjustment_sparse as bas

sys.path.insert(0, "scripts")
from bench_bal_sparse import make_sparse_problem  # noqa: E402


def _sync(*arrays):
    jax.block_until_ready(arrays)


def main():
    n_points = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    n_cams = int(sys.argv[2]) if len(sys.argv) > 2 else 1_600
    window = int(sys.argv[3]) if len(sys.argv) > 3 else 10

    point_idx, cam_idx, xy, X_gt, K, R, t = make_sparse_problem(
        n_points, n_cams, window, dtype=np.float32
    )
    dt = jnp.float32
    obs = bas.SparseObs(
        point_idx=jnp.asarray(point_idx, jnp.int32),
        cam_idx=jnp.asarray(cam_idx, jnp.int32),
        xy=jnp.asarray(np.ascontiguousarray(xy.T), dt),  # lane-major
        weights=jnp.ones((point_idx.shape[0],), dt),
    )
    nf = int(K.shape[0])
    rng = np.random.default_rng(1)
    state = BAState(
        X=jnp.asarray(X_gt + 0.05 * rng.standard_normal(X_gt.shape), dt),
        f=jnp.asarray(K[:, 0, 0], dt),
        u=jnp.asarray(K[:, :2, 2], dt),
        t=jnp.asarray(t + 0.05 * rng.standard_normal(t.shape), dt),
        R=jnp.asarray(R, dt),
    )
    free = gauge_mask(nf, "x-up_z-forward", dt)
    c = jnp.asarray(1e-3, dt)

    # every operand is a jit ARGUMENT: closure-captured device arrays are
    # baked into the HLO as literals, and the factor rows alone are
    # hundreds of MB of HLO constants
    build = jax.jit(
        lambda st, o, fr, cc: bas._build_sparse_system(
            BAState(X=jnp.zeros((0, 3), dt), f=st.f, u=st.u, t=st.t, R=st.R),
            tuple(st.X[:, i] for i in range(3)), o, fr, 1.0, cc,
            None, None, None, "huber", 1 << 16,
        )
    )
    out = {"n_points": int(state.X.shape[0]), "n_cams": nf,
           "n_obs": int(obs.n_obs)}

    r = build(state, obs, free, c)
    _sync(r[3])
    start = time.perf_counter()
    r = build(state, obs, free, c)
    _sync(r[3])
    out["build_s"] = round(time.perf_counter() - start, 4)
    factors, matGc, m_inv, rhs = r[0], r[1], r[2], r[3]
    seen_c = r[8]

    mv = jax.jit(
        lambda v, fa, g, o, fr, sc: bas._schur_matvec(
            v, fa, g, o, fr, sc
        )
    )
    args = (factors, matGc, obs, free, seen_c)
    v = mv(rhs, *args)
    _sync(v)
    n_rep = 10
    start = time.perf_counter()
    for _ in range(n_rep):
        v = mv(v, *args)
    _sync(v)
    out["matvec_s"] = round((time.perf_counter() - start) / n_rep, 5)

    # one full LM iteration (includes the PCG solve), for the total
    config = LMConfig(scale_factor=4.0, delta_tol=0.0, max_iter=1,
                      accept_divisor=1.0, init_damping=1e-3,
                      damping="nielsen", robust="huber")
    run = jax.jit(
        lambda o, st: bas.lm_optimize_sparse(o, st, free, 1.0, config)
    )
    res = run(obs, state)
    _sync(res[0].X)
    start = time.perf_counter()
    res = run(obs, state)
    _sync(res[0].X)
    out["lm_iter_s"] = round(time.perf_counter() - start, 4)
    out["cg_iters"] = int(res[6])
    out["matvec_share_est"] = round(
        out["cg_iters"] * out["matvec_s"] / max(out["lm_iter_s"], 1e-9), 3
    )
    out["build_share_est"] = round(
        out["build_s"] / max(out["lm_iter_s"], 1e-9), 3
    )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
