"""Pallas GPU kernel (Triton route): symmetric rank-k update S = Y^T Y.

This is the hot op of large-scale bundle adjustment: the reduced camera
system accumulates ``sum_p F_p^T Einv_p F_p``, which (via the closed-form
3x3 Cholesky of the damped point blocks) is exactly ``Y^T Y`` with
Y = L^-1 F of shape (3C, 9F) per point chunk. The product is symmetric;
XLA hands the full product to cuBLAS, which computes all N^2 outputs.
This kernel computes ONLY the lower-triangular output tiles — half the
FLOPs — and the caller mirrors once, after the whole chunk scan.

Design:

- the grid is 1-D over the T = nt (nt + 1) / 2 packed lower tiles; each
  program derives its tile coordinates (i, j), i >= j, from
  ``pl.program_id`` (``_tri_ij``), so no upper tile is ever scheduled;
- each program loops over the contraction dimension in ``bk``-row slabs
  (``lax.fori_loop``), multiplying the (bk, bn) column slabs i and j with
  ``pl.dot`` and accumulating the (bn, bn) tile in f32 registers;
- ``precision`` goes to ``pl.dot``: HIGHEST keeps full-FP32 operands
  (IEEE products, no TF32), matching the XLA einsum at HIGHEST; DEFAULT
  lets the tensor cores run TF32.

Upper tiles of the output are never written and hold garbage until
:func:`mirror_lower` masks them. The wrappers take the kernel for
float32 work built for a CUDA device and the XLA einsum everywhere else
(CPU tests, float64 parity runs, float32 work placed on the host); the
choice is made per lowering platform (``lax.platform_dependent``), not
per process. ``interpret=True`` runs the kernel body on the CPU for
tests. Inside ``shard_map`` the output carries the operand's varying
mesh axes (``vma``), as ``check_vma`` requires.

Measured with ``scripts/bench_syrk.py`` on an NVIDIA H100 80GB HBM3 at a
700 W power limit, at K = 2304, N = 9000 (the 100k x 1000 chunk shape),
f32 at HIGHEST, with the tile constants below: 5.10 ms vs 7.86 ms for
the XLA einsum, identical results; the chunked BA at 100k x 1000 (10 LM
iterations) takes 7.10 s with the kernel and 11.32 s with the einsum.
In the tile sweep at 700 W, 64- and 128-wide tiles tie (5.03-5.05 ms);
at a 400 W limit the 128-wide tile was the fastest (5.46 ms vs 8.68 ms
for the einsum). PERF.md has both sweeps.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

# Tile shape: the fastest of the sweep in scripts/bench_syrk.py on the
# H100 at K = 2304, N = 9000 (see PERF.md).
TILE_N = 128
TILE_K = 16
NUM_WARPS = 4
NUM_STAGES = 3


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _tri_ij(t):
    """Packed lower-triangle index t -> tile coordinates (i, j), i >= j,
    with t = i (i + 1) / 2 + j. The float square root can be off by one
    near perfect squares; the two integer corrections make it exact."""
    i = ((jnp.sqrt(8.0 * t.astype(jnp.float32) + 1.0) - 1.0) * 0.5).astype(jnp.int32)
    i = jnp.where((i + 1) * (i + 2) // 2 <= t, i + 1, i)
    i = jnp.where(i * (i + 1) // 2 > t, i - 1, i)
    return i, t - i * (i + 1) // 2


def syrk_lower(
    y: jax.Array, precision=jax.lax.Precision.HIGHEST, tile_n: int = TILE_N,
    tile_k: int = TILE_K, interpret: bool = False,
    num_warps: int = NUM_WARPS, num_stages: int = NUM_STAGES,
) -> jax.Array:
    """Padded lower-triangle-only S = Y^T Y for Y (K, N): returns
    (n_pad, n_pad) f32 with only the (block) lower triangle valid —
    unvisited upper tiles hold garbage. Callers that accumulate many
    SYRKs (the chunked Schur scan) sum these and mirror ONCE at the end
    via :func:`mirror_lower` instead of paying the mirror per chunk."""
    k_dim, n_dim = y.shape
    n_pad = _round_up(n_dim, tile_n)
    k_pad = _round_up(k_dim, tile_k)
    y = jnp.pad(y, ((0, k_pad - k_dim), (0, n_pad - n_dim)))
    nt = n_pad // tile_n
    n_k = k_pad // tile_k

    def kernel(y_ref, out_ref):
        i, j = _tri_ij(pl.program_id(0))

        def body(k, acc):
            rows = pl.ds(k * tile_k, tile_k)
            a = y_ref[rows, pl.ds(i * tile_n, tile_n)]
            b = y_ref[rows, pl.ds(j * tile_n, tile_n)]
            return acc + pl.dot(a, b, trans_a=True, precision=precision)

        acc = jax.lax.fori_loop(
            0, n_k, body, jnp.zeros((tile_n, tile_n), jnp.float32)
        )
        out_ref[pl.ds(i * tile_n, tile_n), pl.ds(j * tile_n, tile_n)] = acc

    route = {} if interpret else dict(
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=num_warps, num_stages=num_stages
        ),
    )
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(
            (n_pad, n_pad), jnp.float32, vma=jax.typeof(y).vma
        ),
        grid=(nt * (nt + 1) // 2,),
        interpret=interpret,
        name="syrk_lower",
        **route,
    )(y)


def mirror_lower(lower: jax.Array, n_dim: int, tile_n: int = TILE_N) -> jax.Array:
    """Complete a :func:`syrk_lower` result: mask the (unwritten) upper
    tiles, transpose the strictly-lower tiles onto the upper side
    (diagonal tiles are already complete and symmetric), unpad."""
    n_pad = lower.shape[0]
    tile_row = jnp.arange(n_pad) // tile_n
    lo = jnp.where(tile_row[:, None] >= tile_row[None, :], lower, 0.0)
    full = lo + jnp.where(tile_row[:, None] > tile_row[None, :], lo, 0.0).T
    return full[:n_dim, :n_dim]


@partial(jax.jit, static_argnames=("precision", "tile_n", "tile_k",
                                   "interpret", "num_warps", "num_stages"))
def syrk(y: jax.Array, precision=jax.lax.Precision.HIGHEST,
         tile_n: int = TILE_N, tile_k: int = TILE_K,
         interpret: bool = False, num_warps: int = NUM_WARPS,
         num_stages: int = NUM_STAGES) -> jax.Array:
    """S = Y^T Y for Y (K, N): lower tiles by the kernel, mirrored.
    Accepts f32 or bf16; accumulates in f32 and returns f32 (N, N)."""
    lower = syrk_lower(y, precision, tile_n, tile_k, interpret=interpret,
                       num_warps=num_warps, num_stages=num_stages)
    return mirror_lower(lower, y.shape[1], tile_n)


def _uses_kernel(dtype) -> bool:
    """The kernel is written for float32 operands; other dtypes always
    take the einsum."""
    return jnp.dtype(dtype) == jnp.float32


def _kernel_or_einsum(kernel, einsum, x):
    """``kernel(x)`` where the computation is lowered for a CUDA device,
    ``einsum(x)`` for every other platform. Both must return the same
    shape."""
    return jax.lax.platform_dependent(x, cuda=kernel, default=einsum)


def syrk_or_fallback(y: jax.Array, precision) -> jax.Array:
    """Symmetric product Y^T Y: the kernel on a CUDA device (f32), the
    XLA einsum at ``precision`` elsewhere."""
    def einsum(y):
        return jnp.einsum("km,kn->mn", y, y, precision=precision)

    if not _uses_kernel(y.dtype):
        return einsum(y)
    n_dim = y.shape[1]
    return _kernel_or_einsum(
        lambda y: mirror_lower(syrk_lower(y, precision), n_dim), einsum, y
    )


def syrk_accumulator_dim(n_dim: int, dtype) -> int:
    """Accumulator side length for :func:`syrk_lower_or_fallback`: the
    kernel's padded width for float32, ``n_dim`` otherwise."""
    return _round_up(n_dim, TILE_N) if _uses_kernel(dtype) else n_dim


def syrk_lower_or_fallback(y: jax.Array, precision, n_acc: int) -> jax.Array:
    """Accumulation-friendly variant: returns an (n_acc, n_acc) partial
    whose mirror is deferred to :func:`finish_syrk_accumulator` —
    per-chunk calls in a scan sum these directly. ``n_acc`` must be
    ``syrk_accumulator_dim(N, y.dtype)``."""
    n_dim = y.shape[1]

    def einsum(y):
        full = jnp.einsum("km,kn->mn", y, y, precision=precision)
        return jnp.pad(full, ((0, n_acc - n_dim), (0, n_acc - n_dim)))

    if not _uses_kernel(y.dtype):
        return einsum(y)
    return _kernel_or_einsum(lambda y: syrk_lower(y, precision), einsum, y)


def finish_syrk_accumulator(acc: jax.Array, n_dim: int, dtype) -> jax.Array:
    """Mirror/unpad an accumulated :func:`syrk_lower_or_fallback` sum."""
    def unpad(acc):
        return acc[:n_dim, :n_dim]

    if not _uses_kernel(dtype):
        return unpad(acc)
    return _kernel_or_einsum(lambda acc: mirror_lower(acc, n_dim), unpad, acc)
