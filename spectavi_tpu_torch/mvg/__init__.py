"""``spectavi_tpu_torch.mvg`` — multi-view geometry.

Same public API as ``spectavi_tpu.mvg``: ``hnormalize``,
``seven_point_algorithm``, ``dlt_triangulate``,
``dlt_reprojection_error``, ``ransac_fitter``,
``image_pair_rectification``, ``ransac_essential_batch``, backed by
batched torch code.  The reference-API wrappers take numpy, compute in
float64 on ``device`` (the card by default; ``device="cpu"`` for the
CPU) and return numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from spectavi_tpu_torch import resolve_device
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
from spectavi_tpu_torch.mvg.ransac import (  # noqa: F401
    DEFAULT_OPTIONS,
    ransac_essential_batch,
    ransac_fitter,
)
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


def _f64(a, dev):
    return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)


def seven_point_algorithm(x, xp, device="cuda"):
    """Single-sample 7-point solve: ``(7, 2)`` euclidean or ``(7, 3)``
    homogeneous points in, the real solutions stacked as
    ``(3*nroot, 3)`` out."""
    dev = resolve_device(device)
    x = np.asarray(x, dtype=np.float64)
    xp = np.asarray(xp, dtype=np.float64)
    if not (x.shape[0] == 7 and xp.shape[0] == 7):
        raise TypeError("Must be 7 points.")
    if not (x.shape[1] == 2 and xp.shape[1] == 2):
        x, xp = x[:, :-1] / x[:, -1:], xp[:, :-1] / xp[:, -1:]
    F, valid = seven_point(_f64(x, dev), _f64(xp, dev))
    F = F.cpu().numpy()
    valid = valid.cpu().numpy()
    return np.vstack(list(F[valid])) if valid.any() else np.zeros((0, 3))


def dlt_triangulate(P0, P1, x, xp, ret_error=False, device="cuda"):
    """Batched DLT triangulation with the reference signature:
    homogeneous ``(npt, 3)`` inputs, ``(npt, 4)`` points or ``(npt, 1)``
    errors out."""
    dev = resolve_device(device)
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
    args = (_f64(P0, dev), _f64(P1, dev), _f64(x, dev), _f64(xp, dev))
    if ret_error:
        return reprojection_error(*args).cpu().numpy()[:, None]
    return triangulate(*args).cpu().numpy()


def dlt_reprojection_error(P0, P1, x, xp, device="cuda"):
    return dlt_triangulate(P0, P1, x, xp, ret_error=True, device=device)
