"""Worker process for test_distributed.py.

Joins an N-process CPU rig via ``runtime.distributed.initialize`` (gloo
collectives — the same program shape a multi-host fleet runs), then:

1. runs one point-sharded LM step over a GLOBAL ``points`` mesh whose
   psums cross the process boundary, and checks the result against
   single-device numerics computed locally (x64: exact up to psum
   reassociation);
2. runs one step over the hybrid (scenes=processes, points=local) mesh —
   scenes-DP across the process boundary, psums intra-process.

Prints WORKER-OK and exits 0 on success. Usage:
    python tests/distributed_worker.py PORT PROCESS_ID NUM_PROCESSES N_LOCAL
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax


def main() -> None:
    port, pid, nproc, n_local = (int(a) for a in sys.argv[1:5])
    jax.config.update("jax_enable_x64", True)

    from mvrecon_tpu.runtime.distributed import (
        distribute_array,
        gather_array,
        initialize,
        points_mesh,
        process_scene_point_mesh,
        replicate_array,
    )

    initialize(
        f"127.0.0.1:{port}", nproc, pid, platform="cpu",
        local_device_count=n_local,
    )
    assert len(jax.devices()) == nproc * n_local
    assert len(jax.local_devices()) == n_local

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from __graft_entry__ import _make_problem
    from mvrecon_tpu.models.bundle_adjustment import BAState, lm_step

    dtype = jnp.float64
    n_dev = nproc * n_local
    x, state, vis, free = _make_problem(jax.random.key(0), 6, n_dev * 20, dtype)
    c = jnp.asarray(1e-4, dtype)

    # Single-device reference (local device 0, no collectives).
    ref_state, _, ref_e1 = lm_step(x, state, vis, free, 1.0, c)
    ref_X = np.asarray(ref_state.X)

    def local_step(x_l, X_l, f_r, u_r, t_r, R_l, vis_l, free_r, c_r):
        st = BAState(X=X_l, f=f_r, u=u_r, t=t_r, R=R_l)
        new, _, e1 = lm_step(x_l, st, vis_l, free_r, 1.0, c_r, axis_name="points")
        return new.X, e1

    # --- 1. points mesh spanning processes (psum crosses the boundary) ---
    mesh = points_mesh()
    pt = P("points")
    xg = distribute_array(mesh, pt, x)
    Xg = distribute_array(mesh, pt, state.X)
    visg = distribute_array(mesh, pt, vis)
    reps = [replicate_array(mesh, a) for a in
            (state.f, state.u, state.t, state.R, free, c)]
    f_r, u_r, t_r, R_r, free_r, c_r = reps

    step = jax.jit(
        jax.shard_map(
            local_step, mesh=mesh,
            in_specs=(pt, pt, P(), P(), P(), P(), pt, P(), P()),
            out_specs=(pt, P()),
        )
    )
    Xn, e1 = step(xg, Xg, f_r, u_r, t_r, R_r, visg, free_r, c_r)
    np.testing.assert_allclose(float(e1), float(ref_e1), rtol=1e-10)
    np.testing.assert_allclose(gather_array(Xn), ref_X, atol=1e-9)
    print(f"proc {pid}: cross-process points-mesh step OK", flush=True)

    # --- 1b. the same step through the radial distortion chain (the
    # BAL camera model is per-observation elementwise work, so the only
    # cross-process traffic is still the Schur psum) ---
    dist = jnp.asarray(np.broadcast_to([-0.3, 0.05], (6, 2)), dtype)
    ref_state_d, _, ref_e1_d = lm_step(x, state, vis, free, 1.0, c, dist=dist)

    def local_step_d(x_l, X_l, f_r_, u_r_, t_r_, R_l, vis_l, free_, c_, d_):
        st = BAState(X=X_l, f=f_r_, u=u_r_, t=t_r_, R=R_l)
        new, _, e1 = lm_step(
            x_l, st, vis_l, free_, 1.0, c_, axis_name="points", dist=d_
        )
        return new.X, e1

    step_d = jax.jit(
        jax.shard_map(
            local_step_d, mesh=mesh,
            in_specs=(pt, pt, P(), P(), P(), P(), pt, P(), P(), P()),
            out_specs=(pt, P()),
        )
    )
    Xn_d, e1_d = step_d(
        xg, Xg, f_r, u_r, t_r, R_r, visg, free_r, c_r,
        replicate_array(mesh, dist),
    )
    np.testing.assert_allclose(float(e1_d), float(ref_e1_d), rtol=1e-10)
    np.testing.assert_allclose(
        gather_array(Xn_d), np.asarray(ref_state_d.X), atol=1e-9
    )
    print(f"proc {pid}: cross-process distorted step OK", flush=True)

    # --- 2. hybrid mesh: scenes axis == process axis ---
    hmesh = process_scene_point_mesh()
    assert hmesh.shape == {"scenes": nproc, "points": n_local}
    # one scene per process, points sharded intra-process only
    xh, sth, vish, free_h = _make_problem(jax.random.key(2), 4, n_local * 20, dtype)
    sp = P("scenes", "points")
    sc = P("scenes")
    stack = lambda a: np.broadcast_to(np.asarray(a), (nproc,) + a.shape)

    def scene_step(x_l, X_l, f_l, u_l, t_l, R_l, vis_l, free_r, c_r):
        def one(x1, X1, f1, u1, t1, R1, v1):
            st = BAState(X=X1, f=f1, u=u1, t=t1, R=R1)
            new, _, e1 = lm_step(x1, st, v1, free_r, 1.0, c_r, axis_name="points")
            return new.X, e1

        return jax.vmap(one)(x_l, X_l, f_l, u_l, t_l, R_l, vis_l)

    ref_h_state, _, ref_h_e1 = lm_step(xh, sth, vish, free_h, 1.0, c)
    hstep = jax.jit(
        jax.shard_map(
            scene_step, mesh=hmesh,
            in_specs=(sp, sp, sc, sc, sc, sc, sp, P(), P()),
            out_specs=(sp, sc),
        )
    )
    args = (
        distribute_array(hmesh, sp, stack(xh)),
        distribute_array(hmesh, sp, stack(sth.X)),
        distribute_array(hmesh, sc, stack(sth.f)),
        distribute_array(hmesh, sc, stack(sth.u)),
        distribute_array(hmesh, sc, stack(sth.t)),
        distribute_array(hmesh, sc, stack(sth.R)),
        distribute_array(hmesh, sp, stack(vish)),
        replicate_array(hmesh, free_h),
        replicate_array(hmesh, c),
    )
    Xh, e1h = hstep(*args)
    e1h_all = gather_array(e1h)
    np.testing.assert_allclose(e1h_all, float(ref_h_e1), rtol=1e-10)
    np.testing.assert_allclose(
        gather_array(Xh), stack(np.asarray(ref_h_state.X)), atol=1e-9
    )
    print(f"proc {pid}: hybrid scenes-over-processes step OK", flush=True)

    print(f"proc {pid}: WORKER-OK", flush=True)


if __name__ == "__main__":
    main()
