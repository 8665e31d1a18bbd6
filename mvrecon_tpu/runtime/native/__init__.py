"""Native (C++) host runtime components, loaded via ctypes.

The compute path is JAX/XLA; these are the sequential host-side pieces that
do not belong on the accelerator (view-graph MST ordering, data packing). Built by
``runtime/native/build.sh`` (g++); every wrapper degrades to a NumPy
fallback when the shared library has not been built.
"""

from . import mst_native  # noqa: F401
