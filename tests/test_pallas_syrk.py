"""Pallas SYRK kernel: interpret-mode correctness on the CPU mesh."""

import numpy as np
import jax.numpy as jnp

from mvrecon_tpu.ops.pallas_syrk import syrk


def test_syrk_interpret_matches_einsum():
    rng = np.random.default_rng(0)
    y = rng.normal(size=(384, 640)).astype(np.float32)
    got = np.asarray(syrk(jnp.asarray(y), tile_n=256, tile_k=128, interpret=True))
    expected = y.T @ y
    np.testing.assert_allclose(got, expected, rtol=2e-5, atol=1e-4)
    # exact symmetry by construction
    np.testing.assert_array_equal(got, got.T)


def test_syrk_interpret_unaligned_shapes():
    rng = np.random.default_rng(1)
    y = rng.normal(size=(100, 300)).astype(np.float32)  # not tile multiples
    got = np.asarray(syrk(jnp.asarray(y), tile_n=128, tile_k=64, interpret=True))
    expected = y.T @ y
    np.testing.assert_allclose(got, expected, rtol=2e-5, atol=1e-4)


def test_syrk_interpret_bf16_inputs():
    """bf16 inputs accumulate in f32."""
    rng = np.random.default_rng(2)
    y = rng.normal(size=(256, 384)).astype(np.float32)
    got = np.asarray(
        syrk(jnp.asarray(y).astype(jnp.bfloat16), tile_n=128, tile_k=128, interpret=True)
    )
    expected = y.T @ y
    # bf16 mantissa: ~1e-2 relative
    np.testing.assert_allclose(got, expected, rtol=5e-2, atol=5e-1)
    np.testing.assert_array_equal(got, got.T)
