"""Batched DLT triangulation, reprojection error and cheirality.

Port of ``spectavi_tpu/mvg/triangulate.py``: the whole correspondence
set (and, inside RANSAC, the hypothesis x camera x point tensor) is one
batched solve.
"""

from __future__ import annotations

import torch

from spectavi_tpu_torch.mvg.core import _det3, hnormalize, inv3x3


def _dlt_system(P0, P1, x0, x1):
    """The 4x4 DLT systems for ``P (..., 3, 4)`` and ``x (..., 2)``."""
    A0 = x0[..., 0:1] * P0[..., 2, :] - P0[..., 0, :]
    A1 = x0[..., 1:2] * P0[..., 2, :] - P0[..., 1, :]
    A2 = x1[..., 0:1] * P1[..., 2, :] - P1[..., 0, :]
    A3 = x1[..., 1:2] * P1[..., 2, :] - P1[..., 1, :]
    A0, A1, A2, A3 = torch.broadcast_tensors(A0, A1, A2, A3)
    return torch.stack([A0, A1, A2, A3], dim=-2)


def _euclid(x):
    return hnormalize(x) if x.shape[-1] == 3 else x


def triangulate(P0, P1, x0, x1):
    """Homogeneous 3D points ``(..., 4)``: the unit SVD null vector of
    the DLT system (reference convention)."""
    A = _dlt_system(P0, P1, _euclid(x0), _euclid(x1))
    _, _, Vt = torch.linalg.svd(A)
    return Vt[..., 3, :]


def _reproj_cheirality(P0, P1, X, x0, x1):
    rp0 = torch.einsum("...ij,...j->...i", P0, X)
    rp1 = torch.einsum("...ij,...j->...i", P1, X)
    err0 = torch.linalg.vector_norm(hnormalize(rp0) - x0, dim=-1)
    err1 = torch.linalg.vector_norm(hnormalize(rp1) - x1, dim=-1)
    sign0 = torch.sign(_det3(P0[..., :3, :3]))
    sign0 = torch.where(sign0 == 0, torch.ones_like(sign0), sign0)
    sign1 = torch.sign(_det3(P1[..., :3, :3]))
    sign1 = torch.where(sign1 == 0, torch.ones_like(sign1), sign1)
    return rp0, rp1, err0 + err1, sign0, sign1


def triangulate_full(P0, P1, x0, x1):
    """``(X, reproj_err, in_front)``: SVD triangulation, the sum of the
    two per-view reprojection residual norms, and the cheirality test."""
    x0, x1 = _euclid(x0), _euclid(x1)
    X = triangulate(P0, P1, x0, x1)
    rp0, rp1, reproj, sign0, sign1 = _reproj_cheirality(P0, P1, X, x0, x1)
    d0 = sign0 * rp0[..., 2] / X[..., 3]
    d1 = sign1 * rp1[..., 2] / X[..., 3]
    in_front = (d0 > 0) & (d1 > 0)
    return X, reproj, in_front


def reprojection_error(P0, P1, x0, x1):
    """Reprojection error of the DLT solution."""
    return triangulate_full(P0, P1, x0, x1)[1]


def triangulate_fast_full(P0, P1, x0, x1):
    """Closed-form scoring triangulation: the inhomogeneous DLT least
    squares through 3x3 normal equations (``X = (w, 1)``).  Returns
    ``(X (..., 4), reproj_err, in_front)``."""
    x0, x1 = _euclid(x0), _euclid(x1)
    A = _dlt_system(P0, P1, x0, x1)
    B = A[..., :3]
    c = A[..., 3]
    BtB = B.transpose(-1, -2) @ B
    Btc = torch.einsum("...ij,...i->...j", B, c)
    w = -torch.einsum("...ij,...j->...i", inv3x3(BtB), Btc)
    X = torch.cat([w, torch.ones_like(w[..., :1])], dim=-1)
    rp0, rp1, reproj, sign0, sign1 = _reproj_cheirality(P0, P1, X, x0, x1)
    in_front = (sign0 * rp0[..., 2] > 0) & (sign1 * rp1[..., 2] > 0)
    finite = torch.all(torch.isfinite(X), dim=-1)
    reproj = torch.where(finite, reproj, torch.full_like(reproj, float("inf")))
    return X, reproj, in_front & finite
