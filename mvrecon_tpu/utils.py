"""Reference-compatible ``utils`` module (API parity with ``lib/utils.py``).

The samplers keep the reference's *signatures* (global-seed style) for
drop-in use; the explicit-key (jax.random) versions live in
``geometry/scenes.py``. Here randomness uses NumPy's global RNG exactly like
the reference so existing user code behaves identically, then converts to
JAX arrays.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .ops.rotations import rodrigues, unit_vec as _unit_vec
from .geometry.scenes import curved_tube_points


def unit_vec(x):
    """Reference ``utils.py:5-7``."""
    return _unit_vec(jnp.asarray(x))


def get_rotation_matrix(omega):
    """Axis-angle -> rotation matrix (reference ``utils.py:10-29``)."""
    return rodrigues(jnp.asarray(omega))


def sample_normal_dist(scale: float, n: int):
    """Reference ``utils.py:32-33`` (NumPy global RNG for compatibility)."""
    return jnp.asarray(np.random.normal(0, scale, (n, 3)))


def add_noise(X, scale: float):
    """Reference ``utils.py:36-37``."""
    X = np.asarray(X)
    return jnp.asarray(X + np.random.normal(0, scale, X.shape))


def sample_hemisphere_points(num: int, r: float):
    """Reference ``utils.py:40-52``: uniform (theta, phi) on the x >= 0
    hemisphere, one point at a time from the global NumPy RNG (sampling
    order preserved so seeded scripts reproduce)."""
    points = []
    for _ in range(num):
        theta = np.random.uniform(0, np.pi / 2)
        phi = np.random.uniform(0, 2 * np.pi)
        points.append(
            (r * np.cos(theta), r * np.sin(theta) * np.cos(phi), r * np.sin(theta) * np.sin(phi))
        )
    return jnp.asarray(np.array(points))


def set_points():
    """The canonical 200-point curved-tube scene (reference
    ``utils.py:55-63``)."""
    return curved_tube_points()
