"""``spectavi_tpu_torch.mvg`` — multi-view geometry.

Same public API as ``spectavi_tpu.mvg``: ``hnormalize``,
``seven_point_algorithm``, ``dlt_triangulate``,
``dlt_reprojection_error``, ``ransac_fitter``,
``image_pair_rectification``, backed by batched torch code.  The
reference-API wrappers take numpy and compute in float64 on the CPU,
as the reference does.
"""

from __future__ import annotations

import numpy as np
import torch

from spectavi_tpu_torch.mvg.core import (  # noqa: F401
    camera_from_rt,
    cameras_from_svd,
    essential_to_cameras,
    fundamental_from_cameras,
    hnormalize,
    homogeneous,
    identity_camera,
    inv3x3,
    skew_symmetric,
)
from spectavi_tpu_torch.mvg.ransac import DEFAULT_OPTIONS, ransac_fitter  # noqa: F401
from spectavi_tpu_torch.mvg.rectify import (  # noqa: F401
    image_pair_rectification,
    rectify_pair,
    rectify_pair_quantized,
)
from spectavi_tpu_torch.mvg.sevenpoint import seven_point, solve_cubic  # noqa: F401
from spectavi_tpu_torch.mvg.triangulate import (  # noqa: F401
    reprojection_error,
    triangulate,
    triangulate_fast_full,
    triangulate_full,
)


def _f64(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def seven_point_algorithm(x, xp):
    """Single-sample 7-point solve: ``(7, 2)`` euclidean or ``(7, 3)``
    homogeneous points in, the real solutions stacked as
    ``(3*nroot, 3)`` out."""
    x = np.asarray(x, dtype=np.float64)
    xp = np.asarray(xp, dtype=np.float64)
    if not (x.shape[0] == 7 and xp.shape[0] == 7):
        raise TypeError("Must be 7 points.")
    if not (x.shape[1] == 2 and xp.shape[1] == 2):
        x, xp = x[:, :-1] / x[:, -1:], xp[:, :-1] / xp[:, -1:]
    F, valid = seven_point(_f64(x), _f64(xp))
    F = F.numpy()
    valid = valid.numpy()
    return np.vstack(list(F[valid])) if valid.any() else np.zeros((0, 3))


def dlt_triangulate(P0, P1, x, xp, ret_error=False):
    """Batched DLT triangulation with the reference signature:
    homogeneous ``(npt, 3)`` inputs, ``(npt, 4)`` points or ``(npt, 1)``
    errors out."""
    P0 = np.asarray(P0, dtype=np.float64)
    P1 = np.asarray(P1, dtype=np.float64)
    if not (P0.shape == (3, 4) and P1.shape == (3, 4)):
        raise TypeError("P0,P1 must be camera matrices.")
    x = np.asarray(x, dtype=np.float64)
    xp = np.asarray(xp, dtype=np.float64)
    if x.ndim == 1:
        x = x[None, :]
    if xp.ndim == 1:
        xp = xp[None, :]
    if x.shape[0] != xp.shape[0]:
        raise TypeError("Must be same # points or shape.")
    if not (x.ndim == 2 and xp.ndim == 2):
        raise TypeError("Wrong dimensionality of input.")
    if not (x.shape[1] == 3 and xp.shape[1] == 3):
        raise TypeError("Coords must be homogenous.")
    if ret_error:
        err = reprojection_error(_f64(P0), _f64(P1), _f64(x), _f64(xp))
        return err.numpy()[:, None]
    return triangulate(_f64(P0), _f64(P1), _f64(x), _f64(xp)).numpy()


def dlt_reprojection_error(P0, P1, x, xp):
    return dlt_triangulate(P0, P1, x, xp, ret_error=True)
