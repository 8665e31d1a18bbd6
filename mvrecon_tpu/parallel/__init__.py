"""Parallel execution: device meshes, scene-batched (DP) reconstruction,
and point-sharded bundle adjustment (SPMD via GSPMD/shard_map)."""

from .mesh import hybrid_scene_point_mesh, make_mesh, scene_point_mesh  # noqa: F401
from .batched import batched_affine_reconstruction, batched_euclidean_reconstruction  # noqa: F401
from .sharded_ba import sharded_bundle_adjust, sharded_lm_step  # noqa: F401
from .sharded_affine import sharded_affine_self_calibration  # noqa: F401
from .sharded_covariance import sharded_ba_covariance  # noqa: F401
from .pipelines import (  # noqa: F401
    sharded_affine_reconstruction,
    sharded_euclidean_reconstruction,
)
