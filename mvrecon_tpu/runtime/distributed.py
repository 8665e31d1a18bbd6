"""Multi-process execution: distributed init, global meshes, shard feeding.

Everything multi-device elsewhere in the framework (``parallel/``) is
single-process SPMD: one Python process drives every device, and
``shard_map``/GSPMD emit the collectives. A multi-host fleet (or a CPU
test rig, or one process per GPU) is *multi-process*: each process sees
only its local devices, stitched into one global device set by JAX's
distributed runtime. This module is that process-level half:

- ``initialize``: ``jax.distributed.initialize`` wrapper that also
  handles the CPU test rig (gloo collectives + virtual local devices)
  and one-process-per-GPU launches (``local_device_ids``);
- ``process_scene_point_mesh``: a global (scenes, points) mesh whose
  OUTER axis spans processes — the process boundary is the slow link,
  and the scenes axis is collectives-free by construction (see
  ``parallel.mesh.hybrid_scene_point_mesh``), so cross-process links
  carry no optimization traffic while the per-retry psums stay on the
  intra-process axis;
- ``distribute_array`` / ``replicate_array``: per-process shard feeding
  (each process materializes only its addressable shards via
  ``jax.make_array_from_callback``);
- ``gather_array``: fetch a possibly non-fully-addressable result back
  to every host.

The reference has no distributed anything (single-process NumPy —
SURVEY.md §2). Launch recipe in ``docs/SCALING.md``; end-to-end
N-process CPU test in ``tests/test_distributed.py`` (spawns real
processes and checks the cross-process LM step against single-device
numerics).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    platform: str | None = None,
    local_device_count: int | None = None,
    local_device_ids: list[int] | None = None,
) -> None:
    """Join this process to the global JAX runtime.

    Nothing on a plain GPU host tells JAX of a cluster, so the
    coordinator triple (``coordinator_address`` as ``host:port``,
    ``num_processes``, ``process_id``) is always passed explicitly.
    ``local_device_ids`` restricts this process to those local devices
    (one process per GPU: process i passes ``[i]``). For a multi-process
    CPU rig pass ``platform="cpu"`` and the per-process virtual device
    count: collectives then go through gloo, exercising the same program
    a multi-host fleet runs.

    Must be called before any other JAX API touches the backend (device
    queries included); config updates land first for that reason.
    """
    if platform is not None:
        jax.config.update("jax_platforms", platform)
    if platform == "cpu":
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    if local_device_count is not None:
        jax.config.update("jax_num_cpu_devices", local_device_count)
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def process_scene_point_mesh(
    axes: tuple[str, str] = ("scenes", "points"), devices=None
) -> Mesh:
    """Global (scenes, points) mesh with the outer axis spanning
    processes: shape (n_processes, devices_per_process).

    The process boundary (the slow link of a fleet) carries the
    collectives-free scenes axis; every ``psum`` in the sharded BA/calibration cores
    reduces over the intra-process ``points`` axis only. Devices are
    grouped by ``process_index`` so the layout holds regardless of the
    backend's global ordering.
    """
    devices = list(devices) if devices is not None else jax.devices()
    by_proc: dict[int, list] = {}
    for d in devices:
        by_proc.setdefault(d.process_index, []).append(d)
    counts = {len(v) for v in by_proc.values()}
    if len(counts) != 1:
        raise ValueError(f"uneven local device counts per process: {by_proc}")
    rows = [by_proc[p] for p in sorted(by_proc)]
    return Mesh(np.asarray(rows), axes)


def points_mesh(devices=None) -> Mesh:
    """1D global ``points`` mesh over all devices (process-major order).
    Cross-process psums ride the inter-process links — use only when one
    scene must span hosts; prefer ``process_scene_point_mesh``."""
    devices = list(devices) if devices is not None else jax.devices()
    ordered = sorted(devices, key=lambda d: (d.process_index, d.id))
    return Mesh(np.asarray(ordered), ("points",))


def distribute_array(mesh: Mesh, spec: PartitionSpec, arr) -> jax.Array:
    """Global array from host data, sharded per ``spec``: each process
    materializes only its addressable shards (the feeding pattern of a
    multi-host fleet). ``arr`` is the full (global-shape) host array —
    deterministically recomputed or loaded per process; the callback
    slices out each local shard, so non-local data is never transferred.
    """
    arr = np.asarray(arr)
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(arr.shape, sharding, lambda idx: arr[idx])


def replicate_array(mesh: Mesh, arr) -> jax.Array:
    """Fully-replicated global array (every device holds a copy)."""
    return distribute_array(mesh, PartitionSpec(), arr)


def gather_array(arr: jax.Array) -> np.ndarray:
    """Fetch a global array to the host on every process, including
    non-fully-addressable results (e.g. the point-sharded X)."""
    if arr.is_fully_addressable:
        return np.asarray(arr)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(arr, tiled=True))
