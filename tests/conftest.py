"""Test configuration.

- Forces the CPU backend with 8 virtual devices so sharded code paths run
  without an accelerator (SURVEY.md §4). Tests that need the GPU carry
  the ``gpu`` marker and skip here.
- Enables x64 so parity tests run in the reference's float64.
- Exposes the reference implementation (read-only, at /root/reference) as a
  parity *oracle*: tests call it and compare outputs; its code is never
  vendored.
"""

import os
import sys

# Tests must run on the virtual 8-device CPU mesh in float64.
# jax.config.update is authoritative even when jax was imported before
# this file (env vars are read at import).
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import contextlib
import io

import numpy as np
import pytest

REFERENCE_PATH = "/root/reference"


def _n_memory_maps() -> int:
    try:
        with open("/proc/self/maps") as fh:
            return sum(1 for _ in fh)
    except OSError:  # non-Linux: no map accounting, no known limit
        return 0


def _map_count_limit() -> int:
    try:
        with open("/proc/sys/vm/max_map_count") as fh:
            return int(fh.read())
    except (OSError, ValueError):
        return 65530  # the Linux default


@pytest.fixture(autouse=True, scope="module")
def _bound_live_executables():
    """Clear JAX's executable caches when the process nears the kernel's
    memory-map limit.

    ROOT CAUSE (bisected 2026-08-18, docs/XLA_CPU_SEGFAULT.md): every
    XLA:CPU compile JITs code through LLVM's ExecutionEngine, costing
    ~500-600 mmap regions per suite-scale executable that are only
    released when the executable is dropped. The kernel caps a process
    at vm.max_map_count mappings (default 65530), so after ~90-150
    suite-scale compiles mmap returns ENOMEM inside LLVM ("LLVM
    compilation error: Cannot allocate memory") and the error path
    segfaults in libgcc's unwinder — the round-3 "late-suite segfault"
    (not OOM: 125 GB free; not heap corruption: MALLOC_CHECK_ clean;
    cleared caches fixed it because clearing unmaps the code pages).

    The round-3 workaround cleared at EVERY module boundary (~3x suite
    wall from recompiles). Now clearing happens only when the map count
    actually approaches the limit — rare on boxes with a raised
    vm.max_map_count, a few times per run at the default.

    ``MVRECON_TEST_NO_CLEAR=1`` disables clearing entirely (the
    reproducer switch)."""
    yield
    if os.environ.get("MVRECON_TEST_NO_CLEAR") == "1":
        return
    limit = _map_count_limit()
    if _n_memory_maps() > 0.6 * limit:
        import jax

        jax.clear_caches()


@pytest.fixture(scope="session")
def ref():
    """Namespace of reference modules used as numeric oracles."""
    if REFERENCE_PATH not in sys.path:
        sys.path.insert(0, REFERENCE_PATH)
    import lib.affine_camera_calibration as affine
    import lib.bundle_adjustment as ba
    import lib.camera as camera
    import lib.factorization as factorization
    import lib.minimum_spanning_tree as mst
    import lib.perspective_camera_calibration as perspective
    import lib.utils as utils

    class Ref:
        pass

    r = Ref()
    r.affine = affine
    r.ba = ba
    r.camera = camera
    r.factorization = factorization
    r.mst = mst
    r.perspective = perspective
    r.utils = utils
    return r


@pytest.fixture(scope="session")
def quiet():
    """Silence the reference's per-iteration prints."""

    @contextlib.contextmanager
    def _quiet():
        with contextlib.redirect_stdout(io.StringIO()):
            yield

    return _quiet


def make_ref_scene(ref, n_images: int, f: float = 1.0, seed: int = 123, noise: float = 0.005):
    """Reference demo scene (``affine_reconstruction.py:15-41`` /
    ``euclidiean_reconstruction.py:14-40``) built *with the reference's own
    code* so both implementations consume byte-identical observations."""
    np.random.seed(seed)
    camera_pos = ref.utils.sample_hemisphere_points(n_images, 5)
    targets = np.random.normal(0, 0.5, (n_images, 3))
    cameras = [
        ref.camera.Camera.create(pos, target, f=f, f0=1.0)
        for pos, target in zip(camera_pos, targets)
    ]
    K, R, t = ref.camera.get_camera_parames(cameras)
    X = ref.utils.set_points()
    x_list = ref.camera.calc_projected_points(X, K, R, t)
    for x in x_list:
        x += noise * np.random.randn(*x.shape)
    return X, K, R, t, x_list
