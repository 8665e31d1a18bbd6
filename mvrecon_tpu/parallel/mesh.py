"""Device-mesh construction helpers.

The framework's two parallelism axes (SURVEY.md §2, items 12-13):

- ``scenes`` — pure data parallelism over independent reconstructions
  (the 256-scenes x 100-views north star);
- ``points`` — intra-scene sharding of the P (feature points) dimension:
  observation rows, per-point Schur blocks, and the point side of every
  einsum are sharded; per-camera quantities stay replicated and are
  combined with ``psum``-style all-reduces (NCCL between GPUs).

There is deliberately no hand-written communication backend: collectives
are emitted by GSPMD from sharding annotations (or explicitly inside
``shard_map`` blocks in ``sharded_ba.py``).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(axis_sizes: dict[str, int], devices=None) -> Mesh:
    """Build a named mesh with the given axis sizes (row-major over the
    available devices)."""
    devices = devices if devices is not None else jax.devices()
    sizes = list(axis_sizes.values())
    n = int(np.prod(sizes))
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    arr = np.asarray(devices[:n]).reshape(sizes)
    return Mesh(arr, tuple(axis_sizes.keys()))


def hybrid_scene_point_mesh(
    n_groups: int, devices=None, axes: tuple[str, str] = ("scenes", "points")
) -> Mesh:
    """(scenes, points) mesh whose outer axis spans ``n_groups`` device
    groups (e.g. hosts), the inner axis the devices of one group.

    The framework's communication pattern makes this split safe by
    construction: the ``scenes`` axis is collectives-free data parallelism
    (independent reconstructions, no cross-scene reduction anywhere), so
    the slow inter-group hop carries zero traffic during optimization; the
    per-retry ``psum`` of camera-side Schur accumulations
    (``sharded_ba.py``) stays inside a group. Mapping ``points`` across
    groups instead would put one (9F, 9F) all-reduce per LM retry on the
    slow link — never do that; this helper makes the fast assignment the
    default.

    Devices are grouped row-major in ``devices`` order: the cards of one
    host are all-to-all connected (NVLink), so any grouping within a host
    is equivalent. Across processes, ``runtime.distributed.
    process_scene_point_mesh`` groups devices by ``process_index``.
    """
    devices = list(devices) if devices is not None else jax.devices()
    if len(devices) % n_groups:
        raise ValueError(
            f"{len(devices)} devices do not split into {n_groups} groups"
        )
    arr = np.asarray(devices).reshape(n_groups, len(devices) // n_groups)
    return Mesh(arr, axes)


def scene_point_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """2D (scenes, points) mesh over ``n_devices``: scenes gets the largest
    power-of-two factor <= sqrt(n), points the rest. For 8 devices this is
    (2 scenes, 4 points)."""
    devices = devices if devices is not None else jax.devices()
    n = n_devices if n_devices is not None else len(devices)
    scenes = 1
    while scenes * 2 <= n // (scenes * 2) and n % (scenes * 2) == 0:
        scenes *= 2
    points = n // scenes
    return make_mesh({"scenes": scenes, "points": points}, devices=devices)
