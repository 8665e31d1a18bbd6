"""North-star workload: 1000-view / 100k-point bundle adjustment on one
device. The reference cannot run this at all (its Schur reduction would
need a (P, 9F, 9F) float64 intermediate — ~65 TB here), so this is
reported separately from bench.py's reference-comparable headline.

Usage: [MVRECON_PRECISION=default] python scripts/bench_northstar.py \
            [n_points] [n_views] [n_iters] [chunk] [accept_div] [delta_tol]
            [init_c] [scale] [damping] [checkpoint_every] [watchdog_s]

With ``checkpoint_every`` > 0 the run is segmented: every N LM iterations
the (X, K, R, t, c, nu) state is checkpointed host-side
(``runtime.checkpoint``) and the next segment resumes from it — the
long-run resilience story for the 100k+-point regime.

With ``watchdog_s`` > 0 a progress watchdog (``runtime.watchdog``) is
armed: if the device backend wedges and no
segment completes within the deadline, the process dumps thread stacks
and exits 124 so a supervising loop can restart it; a restarted
segmented run resumes from the latest checkpoint.
"""

import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

from mvrecon_tpu.runtime.cache import enable_compilation_cache

enable_compilation_cache()

from mvrecon_tpu.config import LMConfig
from mvrecon_tpu.geometry.scenes import make_synthetic_scene
from mvrecon_tpu.models.bundle_adjustment_chunked import bundle_adjust_chunked
from mvrecon_tpu.runtime.checkpoint import save_checkpoint


def main():
    n_points = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    n_views = int(sys.argv[2]) if len(sys.argv) > 2 else 1000
    n_iters = int(sys.argv[3]) if len(sys.argv) > 3 else 10
    chunk = int(sys.argv[4]) if len(sys.argv) > 4 else 4096
    accept_div = float(sys.argv[5]) if len(sys.argv) > 5 else None
    delta_tol = float(sys.argv[6]) if len(sys.argv) > 6 else 0.0
    init_c = float(sys.argv[7]) if len(sys.argv) > 7 else 1e-4
    scale = float(sys.argv[8]) if len(sys.argv) > 8 else 2.0
    damping = sys.argv[9] if len(sys.argv) > 9 else "reference"
    ckpt_every = int(sys.argv[10]) if len(sys.argv) > 10 else 0
    watchdog_s = float(sys.argv[11]) if len(sys.argv) > 11 else 0.0

    dtype = jnp.float32
    key = jax.random.key(0)
    print(f"building scene P={n_points} F={n_views} ...", flush=True)
    scene = make_synthetic_scene(
        key, n_images=n_views, n_slices=n_points // 20, n_angles=20, dtype=dtype
    )
    k1, k2 = jax.random.split(key)
    X0 = scene.X + 0.05 * jax.random.normal(k1, scene.X.shape, dtype=dtype)
    t0 = scene.t + 0.05 * jax.random.normal(k2, scene.t.shape, dtype=dtype)
    x = jax.block_until_ready(scene.x.transpose(1, 0, 2))
    K_s, R_s = scene.K, scene.R
    del scene  # drop the (F, P, 2) original: 4 GB at 1M x 500
    print("scene ready", flush=True)

    config = LMConfig(scale_factor=scale, delta_tol=delta_tol, max_iter=n_iters,
                      accept_divisor=accept_div, init_damping=init_c,
                      damping=damping)

    from mvrecon_tpu.runtime.watchdog import Watchdog

    dog = Watchdog(watchdog_s).start() if watchdog_s > 0 else None

    def run():
        if not ckpt_every:
            res = bundle_adjust_chunked(
                x, X0, K_s, R_s, t0,
                f0=1.0, axis="x-up_z-forward", config=config, chunk_size=chunk,
            )
            err = float(res.error)  # host round-trip = real completion
            if dog is not None:
                dog.pet()
            return res, err
        # segmented run with periodic host-side checkpoints
        seg_cfg = LMConfig(scale_factor=scale, delta_tol=delta_tol,
                           max_iter=ckpt_every, accept_divisor=accept_div,
                           init_damping=init_c, damping=damping)
        Xc, Kc, Rc, tc = X0, K_s, R_s, t0
        c_cur = nu_cur = None
        done = 0
        while done < n_iters:
            res = bundle_adjust_chunked(
                x, Xc, Kc, Rc, tc, f0=1.0, axis="x-up_z-forward",
                config=seg_cfg, chunk_size=chunk,
                init_c=c_cur, init_nu=nu_cur,
            )
            done += int(res.n_iter)
            Xc, Kc, Rc, tc = res.X, res.K, res.R, res.t
            c_cur, nu_cur = res.log["c"], res.log["nu"]
            save_checkpoint(
                "/tmp/northstar_ckpt.npz",
                {"X": Xc, "K": Kc, "R": Rc, "t": tc, "c": c_cur, "nu": nu_cur},
                step=done,
            )
            print(f"  checkpoint at iter {done}: E={float(res.error):.6e}",
                  flush=True)
            if dog is not None:
                dog.pet()
        return res, float(res.error)

    t_start = time.perf_counter()
    res, err = run()
    print(f"first run (incl. compile): {time.perf_counter() - t_start:.2f}s "
          f"E={err:.6e} iters={int(res.n_iter)} "
          f"retries={int(res.log['n_solver_retries'])}", flush=True)

    times = []
    for _ in range(2):
        t_start = time.perf_counter()
        res, err = run()
        times.append(time.perf_counter() - t_start)
    print(
        f"northstar P={n_points} F={n_views} iters={n_iters} chunk={chunk} "
        f"accept_div={accept_div}: wall={min(times):.3f}s E={err:.6e} "
        f"retries={int(res.log['n_solver_retries'])}",
        flush=True,
    )
    if dog is not None:
        dog.stop()


if __name__ == "__main__":
    main()
