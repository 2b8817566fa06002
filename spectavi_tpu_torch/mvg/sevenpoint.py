"""Batched 7-point fundamental-matrix solver.

Port of ``spectavi_tpu/mvg/sevenpoint.py``: the cubic
``det(z F0 + (1-z) F1)`` is recovered from four closed-form
determinants, solved branch-free, and the two-vector null space comes
from modified Gram-Schmidt (``nullspace="mgs"``, the RANSAC path) or
an SVD.  All functions take arbitrary leading batch dims.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-14
_TWOPI = 6.28318530717958648


def det3(M):
    """Closed-form determinant of ``(..., 3, 3)``."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def solve_cubic(a, b, c):
    """Real roots of ``x^3 + a x^2 + b x + c = 0``, batched, branch-free.

    Returns ``(roots, valid)`` of shape ``(..., 3)``."""
    one = torch.ones_like(a)
    a2 = a * a
    q = (a2 - 3.0 * b) / 9.0
    r = (a * (2.0 * a2 - 9.0 * b) + 27.0 * c) / 54.0
    r2 = r * r
    q3 = q * q * q
    three_real = r2 < q3

    q3_safe = torch.where(three_real, q3, one)
    q_safe = torch.where(three_real, q, one)
    t = torch.clamp(r / torch.sqrt(q3_safe), -1.0, 1.0)
    t = torch.arccos(t)
    a3 = a / 3.0
    qq = -2.0 * torch.sqrt(q_safe)
    tri0 = qq * torch.cos(t / 3.0) - a3
    tri1 = qq * torch.cos((t + _TWOPI) / 3.0) - a3
    tri2 = qq * torch.cos((t - _TWOPI) / 3.0) - a3

    disc = torch.where(three_real, torch.zeros_like(a), r2 - q3)
    s = torch.abs(r) + torch.sqrt(disc)
    # real cube root (torch has no cbrt); s >= 0 here
    cb = torch.pow(s, 1.0 / 3.0)
    A = -cb * torch.where(r < 0, -one, one)
    B = torch.where(A == 0, torch.zeros_like(A), q / torch.where(A == 0, one, A))
    car0 = (A + B) - a3
    car1 = -0.5 * (A + B) - a3
    imag = 0.5 * math.sqrt(3.0) * (A - B)
    pair_is_real = torch.abs(imag) < _EPS

    x0 = torch.where(three_real, tri0, car0)
    x1 = torch.where(three_real, tri1, car1)
    x2 = torch.where(three_real, tri2, torch.zeros_like(a))
    v0 = torch.ones_like(three_real)
    v1 = three_real | pair_is_real
    v2 = three_real
    return torch.stack([x0, x1, x2], dim=-1), torch.stack([v0, v1, v2], dim=-1)


def _det_cubic_coeffs(F0, F1):
    """Coefficients ``(a, b, c, d)`` of ``det(z F0 + (1-z) F1)`` in z,
    from evaluations at the nodes 0, 1, -1, 2."""
    p0 = det3(F1)
    p1 = det3(F0)
    pm1 = det3(2.0 * F1 - F0)
    p2 = det3(2.0 * F0 - F1)
    d = p0
    b = 0.5 * (p1 + pm1) - p0
    s1 = p1 - p0 - b
    s2 = 0.5 * (p2 - p0 - 4.0 * b)
    a = (s2 - s1) / 3.0
    c = s1 - a
    return a, b, c, d


def nullspace2_mgs(A):
    """Two-vector null-space basis of batched ``(..., 7, 9)`` systems by
    two-pass modified Gram-Schmidt and the complement projector."""
    qs = []
    for i in range(7):
        v = A[..., i, :]
        for q in qs:
            v = v - torch.sum(q * v, dim=-1, keepdim=True) * q
        for q in qs:
            v = v - torch.sum(q * v, dim=-1, keepdim=True) * q
        n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        qs.append(
            torch.where(n > 1e-25, v / torch.clamp(n, min=1e-30), torch.zeros_like(v))
        )
    Q = torch.stack(qs, dim=-2)
    P = torch.eye(9, dtype=A.dtype, device=A.device) - torch.einsum(
        "...ki,...kj->...ij", Q, Q
    )
    norms = torch.sum(P * P, dim=-2)
    c0 = torch.argmax(norms, dim=-1)
    v0 = torch.take_along_dim(P, c0[..., None, None], dim=-1)[..., 0]
    v0 = v0 / torch.clamp(torch.linalg.vector_norm(v0, dim=-1, keepdim=True), min=1e-30)
    P1 = P - v0[..., :, None] * v0[..., None, :]
    norms1 = torch.sum(P1 * P1, dim=-2)
    c1 = torch.argmax(norms1, dim=-1)
    v1 = torch.take_along_dim(P1, c1[..., None, None], dim=-1)[..., 0]
    v1 = v1 - torch.sum(v0 * v1, dim=-1, keepdim=True) * v0
    v1 = v1 / torch.clamp(torch.linalg.vector_norm(v1, dim=-1, keepdim=True), min=1e-30)
    return v0, v1


def seven_point(x, xp, nullspace="svd"):
    """Batched 7-point algorithm: ``x, xp (..., 7, 2)`` ->
    ``(F (..., 3, 3, 3), valid (..., 3))``."""
    u, v = x[..., 0], x[..., 1]
    up, vp = xp[..., 0], xp[..., 1]
    one = torch.ones_like(u)
    A = torch.stack([up * u, up * v, up, vp * u, vp * v, vp, u, v, one], dim=-1)
    if nullspace == "mgs":
        n0, n1 = nullspace2_mgs(A)
        F0 = n0.reshape(*n0.shape[:-1], 3, 3)
        F1 = n1.reshape(*n1.shape[:-1], 3, 3)
    else:
        _, _, Vt = torch.linalg.svd(A, full_matrices=True)
        F0 = Vt[..., 7, :].reshape(*Vt.shape[:-2], 3, 3)
        F1 = Vt[..., 8, :].reshape(*Vt.shape[:-2], 3, 3)

    a, b, c, d = _det_cubic_coeffs(F0, F1)
    degenerate = torch.abs(a) < _EPS
    a_safe = torch.where(degenerate, torch.ones_like(a), a)
    roots, valid = solve_cubic(b / a_safe, c / a_safe, d / a_safe)
    valid = valid & ~degenerate[..., None]
    F = (
        roots[..., :, None, None] * F0[..., None, :, :]
        + (1.0 - roots[..., :, None, None]) * F1[..., None, :, :]
    )
    return F, valid
