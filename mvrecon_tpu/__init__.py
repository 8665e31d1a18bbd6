"""mvrecon_tpu — multi-view 3D reconstruction framework on JAX/XLA.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
``takah29/3d-reconstruction-from-multi-view-exp`` (Kanatani–Sugaya–Kanazawa,
*Guide to 3D Vision Computation*): Tomasi–Kanade factorization, affine and
perspective camera self-calibration with Euclidean/metric upgrading, and
Levenberg–Marquardt bundle adjustment with camera/point Schur elimination —
all expressed as jitted XLA programs with batched (vmap) and sharded
(shard_map/pjit) execution over device meshes.

Public API (reference-compatible module names, see each module's docstring
for the file:line parity citations into the reference):

- ``mvrecon_tpu.factorization``
- ``mvrecon_tpu.affine_camera_calibration``
- ``mvrecon_tpu.perspective_camera_calibration``
- ``mvrecon_tpu.bundle_adjustment``
- ``mvrecon_tpu.camera`` / ``mvrecon_tpu.utils``
- ``mvrecon_tpu.minimum_spanning_tree``
- ``mvrecon_tpu.visualization``

The core lives in ``ops/`` (kernels), ``models/`` (pipelines),
``geometry/`` (camera & scene synthesis), ``parallel/`` (mesh/sharding),
``runtime/`` (config, logging, checkpointing, native host runtime).
"""

__version__ = "0.1.0"

from . import config  # noqa: F401
