"""Reference-compatible ``affine_camera_calibration`` module.

API parity with ``lib/affine_camera_calibration.py``: same entry points and
signatures; accepts the reference's list-of-(P, 2)-arrays observations (or a
dense (F, P, 2) array, the framework's native form). Returns (S (P, 3), R (F, 3, 3)).
"""

from __future__ import annotations

import jax.numpy as jnp

from .models.affine import affine_self_calibration, observation_matrix


def _as_dense(data_list):
    if isinstance(data_list, (list, tuple)):
        lengths = {len(x) for x in data_list}
        if len(lengths) != 1:
            raise ValueError("all images must observe the same number of points")
        return jnp.stack([jnp.asarray(x) for x in data_list])
    return jnp.asarray(data_list)


def orthographic_self_calibration(data_list):
    """Reference ``affine_camera_calibration.py:7-56``."""
    return affine_self_calibration(_as_dense(data_list), model="orthographic")


def symmetric_affine_self_calibration(data_list):
    """Reference ``affine_camera_calibration.py:59-134``."""
    return affine_self_calibration(_as_dense(data_list), model="symmetric")


def paraperspective_self_calibration(data_list, f):
    """Reference ``affine_camera_calibration.py:137-221``."""
    x = _as_dense(data_list)
    f = jnp.asarray(f)
    if x.shape[0] != f.shape[0]:
        raise ValueError("need one focal length per image")
    return affine_self_calibration(x, model="paraperspective", f=f)


def _get_observation_matrix(data_list):
    """Reference ``affine_camera_calibration.py:224-240``."""
    return observation_matrix(_as_dense(data_list))
