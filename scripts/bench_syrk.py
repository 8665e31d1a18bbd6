"""SYRK benchmark at the 100k x 1000 chunk shape on the GPU: the XLA
einsum against the packed lower-triangle Pallas kernel
(ops/pallas_syrk.py).

Usage: python scripts/bench_syrk.py [--sweep] [--e2e] [K] [N]

Without options: both at HIGHEST (full FP32) and at DEFAULT (TF32), and
the kernel's error against the einsum. ``--sweep`` times the kernel over
a grid of (tile_n, tile_k, num_warps, num_stages). ``--e2e`` times the
chunked BA at 100,000 points x 1,000 views (bench.py's northstar call,
10 LM iterations, warm) with the einsum and with the kernel, in turns
einsum / kernel / kernel / einsum. Prints one JSON object per line,
the card's name and power limit first.
"""

import json
import subprocess
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

from mvrecon_tpu.runtime.cache import enable_compilation_cache

enable_compilation_cache()

from mvrecon_tpu.ops import pallas_syrk
from mvrecon_tpu.ops.pallas_syrk import syrk

P = jax.lax.Precision
SWEEP = [  # (tile_n, tile_k, num_warps, num_stages)
    (32, 16, 2, 3), (64, 16, 2, 3), (64, 16, 4, 3), (64, 32, 2, 3),
    (128, 16, 4, 3), (128, 16, 8, 3), (128, 32, 4, 3),
]


def median_ms(fn, *args, n=10):
    out = jax.block_until_ready(fn(*args))
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times)), out


def emit(**rec):
    print(json.dumps(rec), flush=True)


def micro(y):
    flops = 2 * y.shape[0] * y.shape[1] ** 2  # full product; the kernel does ~half
    ref = None
    for name, fn in [
        ("einsum HIGHEST", jax.jit(lambda y: jnp.einsum(
            "km,kn->mn", y, y, precision=P.HIGHEST))),
        ("einsum DEFAULT (TF32)", jax.jit(lambda y: jnp.einsum(
            "km,kn->mn", y, y, precision=P.DEFAULT))),
        ("kernel HIGHEST", lambda y: syrk(y, P.HIGHEST)),
        ("kernel DEFAULT (TF32)", lambda y: syrk(y, P.DEFAULT)),
    ]:
        ms, out = median_ms(fn, y)
        ref = out if ref is None else ref
        err = float(jnp.linalg.norm(out - ref) / jnp.linalg.norm(ref))
        emit(op=name, ms=ms, tflops=flops / ms / 1e9, rel_err_vs_einsum_highest=err)


def sweep(y):
    ref = jnp.einsum("km,kn->mn", y, y, precision=P.HIGHEST)
    for tile_n, tile_k, warps, stages in SWEEP:
        ms, out = median_ms(lambda y: syrk(
            y, P.HIGHEST, tile_n=tile_n, tile_k=tile_k, num_warps=warps,
            num_stages=stages), y)
        err = float(jnp.linalg.norm(out - ref) / jnp.linalg.norm(ref))
        emit(tile_n=tile_n, tile_k=tile_k, num_warps=warps, num_stages=stages,
             ms=ms, rel_err_vs_einsum=err)


def e2e():
    import bench

    dispatch = pallas_syrk._kernel_or_einsum
    modes = {"kernel": dispatch, "einsum": lambda kernel, einsum, x: einsum(x)}
    current = None
    for name in ("einsum", "kernel", "kernel", "einsum"):
        if name != current:
            pallas_syrk._kernel_or_einsum = modes[name]
            jax.clear_caches()  # the dispatch is read at trace time
            current = name
        stats, _ = bench.bench_northstar(n_iters=10)
        emit(e2e=name, wall_s=stats["wall_s"], wall_s_spread=stats["wall_s_spread"],
             E=stats["reprojection_error"], retries=stats["retries"])
    pallas_syrk._kernel_or_einsum = dispatch


def main():
    if jax.default_backend() != "gpu":
        sys.exit("bench_syrk: needs a GPU backend")
    flags = {a for a in sys.argv[1:] if a.startswith("--")}
    pos = [int(a) for a in sys.argv[1:] if not a.startswith("--")]
    K, N = (pos + [3 * 768, 9000][len(pos):])[:2]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    y = jax.random.normal(jax.random.key(0), (K, N), dtype=jnp.float32)
    emit(K=K, N=N, device=jax.devices()[0].device_kind)
    micro(y)
    if "--sweep" in flags:
        sweep(y)
    if "--e2e" in flags:
        e2e()


if __name__ == "__main__":
    main()
