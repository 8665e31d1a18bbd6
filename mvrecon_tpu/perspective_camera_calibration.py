"""Reference-compatible ``perspective_camera_calibration`` module.

API parity with ``lib/perspective_camera_calibration.py``: the public
``perspective_self_calibration(x_list, f0, tol, method)`` returns
(X, R, t, K) like the reference (``:513-540``); convergence status is
available via ``perspective_self_calibration_full`` which also returns the
depth-loop diagnostics (the jitted core reports failure as a status
flag instead of raising inside the graph).
"""

from __future__ import annotations

import warnings

import jax.numpy as jnp

from .models.perspective import (
    CalibrationResult,
    STATUS_MAX_ITER,
    STATUS_OMEGA_INDEFINITE,
    correct_world_coordinates,  # noqa: F401 (reference API, ``:500-510``)
    perspective_self_calibration as _core,
)


def _as_dense(x_list):
    if isinstance(x_list, (list, tuple)):
        lengths = {len(x) for x in x_list}
        if len(lengths) != 1:
            raise ValueError("all images must observe the same number of points")
        return jnp.stack([jnp.asarray(x) for x in x_list])
    return jnp.asarray(x_list)


def perspective_self_calibration_full(
    x_list, f0: float = 1.0, tol: float = 0.01, method: str = "primary",
    eig_method: str = "eigh",
) -> CalibrationResult:
    """Full result with convergence diagnostics. ``eig_method="lowrank"``
    (alias ``"power"``) selects the exact low-rank-factor eigensolve fast
    path for the depth loops."""
    return _core(_as_dense(x_list), f0=f0, tol=tol, method=method,
                 eig_method=eig_method)


def perspective_self_calibration(
    x_list, f0: float = 1.0, tol: float = 0.01, method: str = "primary",
    eig_method: str = "eigh",
):
    """Reference ``perspective_camera_calibration.py:513-540``: returns
    (X, R, t, K). Eager by contract (one scalar host fetch of the status
    flag): raises ValueError if the metric upgrade hit the reference's
    indefinite-Omega failure (``:332/:401``) and warns if the depth loop
    stopped at max_iter without converging (the reference prints this
    warning at ``:141-143/:232-234``). Use
    :func:`perspective_self_calibration_full` for the non-blocking variant
    that returns the status as data."""
    res = perspective_self_calibration_full(
        x_list, f0=f0, tol=tol, method=method, eig_method=eig_method
    )
    status = int(res.status)
    if status == STATUS_OMEGA_INDEFINITE:
        raise ValueError("dual absolute quadric has indefinite spectrum")
    if status == STATUS_MAX_ITER:
        warnings.warn(
            "projective depth iteration hit max_iter without reaching the "
            f"tolerance (final error {float(res.depth_error):.3e})",
            RuntimeWarning,
            stacklevel=2,
        )
    return res.X, res.R, res.t, res.K
