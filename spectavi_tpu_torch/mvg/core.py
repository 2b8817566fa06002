"""Core projective-geometry primitives over arbitrary leading batch dims.

Port of ``spectavi_tpu/mvg/core.py``.  The closed forms
(:func:`eigh3x3_descending`, :func:`svd3x3`, :func:`inv3x3`) are kept
as written there instead of ``torch.linalg`` calls: the RANSAC winner
depends on their rounding, and they are cheap batched elementwise code
on the card.
"""

from __future__ import annotations

import math

import torch


def hnormalize(x):
    """Homogeneous -> euclidean along the last axis."""
    return x[..., :-1] / x[..., -1:]


def homogeneous(x):
    """Append a 1-coordinate along the last axis."""
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def skew_symmetric(s):
    """Vectors ``(..., 3)`` -> skew-symmetric matrices ``(..., 3, 3)``."""
    s0, s1, s2 = s[..., 0], s[..., 1], s[..., 2]
    z = torch.zeros_like(s0)
    return torch.stack(
        [
            torch.stack([z, -s2, s1], dim=-1),
            torch.stack([s2, z, -s0], dim=-1),
            torch.stack([-s1, s0, z], dim=-1),
        ],
        dim=-2,
    )


def camera_from_rt(R, t):
    """``P = [R | t]`` from ``(..., 3, 3)`` and ``(..., 3)``."""
    return torch.cat([R, t[..., None]], dim=-1)


def identity_camera(dtype=torch.float64, device=None):
    """The canonical camera ``[I | 0]``."""
    return torch.cat(
        [
            torch.eye(3, dtype=dtype, device=device),
            torch.zeros((3, 1), dtype=dtype, device=device),
        ],
        dim=-1,
    )


def _det3(M):
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def essential_to_cameras(E):
    """Essential matrices ``(..., 3, 3)`` -> 4 candidate cameras
    ``(..., 4, 3, 4)`` (reference ``Essential2Cameras``)."""
    U, _, Vt = torch.linalg.svd(E)
    return cameras_from_svd(U, Vt)


def cameras_from_svd(U, Vt):
    """Candidate cameras ``(Ra, t), (Ra, -t), (Rb, t), (Rb, -t)`` from a
    precomputed SVD of E, with the rotations forced proper (det +1) as
    in the JAX package."""
    D = torch.tensor(
        [[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
        dtype=U.dtype, device=U.device,
    )
    t = U[..., :, 2]
    s = torch.sign(_det3(U @ Vt))[..., None, None]
    Ra = U @ D @ Vt * s
    Rb = U @ D.T @ Vt * s
    return torch.stack(
        [
            camera_from_rt(Ra, t),
            camera_from_rt(Ra, -t),
            camera_from_rt(Rb, t),
            camera_from_rt(Rb, -t),
        ],
        dim=-3,
    )


def _vec3(vals, like):
    return torch.tensor(vals, dtype=like.dtype, device=like.device)


def eigh3x3_descending(G):
    """Closed-form eigendecomposition of symmetric ``(..., 3, 3)``
    (trigonometric eigenvalues, Cayley-Hamilton anchor vector, exact
    2x2 Jacobi rotation for the remaining pair).  Returns ``(w, V)``
    with eigenvalues descending and ``V``'s columns the eigenvectors."""
    dtype, device = G.dtype, G.device
    q = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1) / 3.0
    I = torch.eye(3, dtype=dtype, device=device)
    B = G - q[..., None, None] * I
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=0.0))
    p_safe = torch.where(p > 0, p, torch.ones_like(p))
    detB = (
        B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 1])
        - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 0])
        + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1] - B[..., 1, 1] * B[..., 2, 0])
    )
    r = torch.clamp(detB / (2.0 * p_safe**3), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    l0 = q + 2.0 * p * torch.cos(phi)
    l2 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    l1 = 3.0 * q - l0 - l2

    anchor_low = (l1 - l2) >= (l0 - l1)
    la = torch.where(anchor_low, l2, l0)
    lb = torch.where(anchor_low, l0, l1)
    lc = torch.where(anchor_low, l1, l2)
    P = (G - lb[..., None, None] * I) @ (G - lc[..., None, None] * I)
    norms = torch.sum(P * P, dim=-2)
    ci = torch.argmax(norms, dim=-1)
    va = torch.take_along_dim(P, ci[..., None, None], dim=-1)[..., 0]
    na = torch.linalg.vector_norm(va, dim=-1, keepdim=True)
    va = torch.where(
        na > 1e-30, va / torch.clamp(na, min=1e-30), _vec3([0.0, 0.0, 1.0], G)
    )

    ex = _vec3([1.0, 0.0, 0.0], G).expand_as(va)
    ey = _vec3([0.0, 1.0, 0.0], G).expand_as(va)
    e = torch.where(torch.abs(va[..., 0:1]) < 0.9, ex, ey)
    a = torch.linalg.cross(va, e)
    a = a / torch.clamp(torch.linalg.vector_norm(a, dim=-1, keepdim=True), min=1e-30)
    b = torch.linalg.cross(va, a)

    Ga = torch.einsum("...ij,...j->...i", G, a)
    Gb = torch.einsum("...ij,...j->...i", G, b)
    al = torch.sum(a * Ga, dim=-1)
    be = torch.sum(b * Gb, dim=-1)
    ga = torch.sum(a * Gb, dim=-1)
    th = 0.5 * torch.arctan2(2.0 * ga, al - be)
    c, s = torch.cos(th), torch.sin(th)
    u = c[..., None] * a + s[..., None] * b
    w_ = -s[..., None] * a + c[..., None] * b
    lu = al * c**2 + 2 * ga * c * s + be * s**2
    lw = al * s**2 - 2 * ga * c * s + be * c**2
    swap = lw > lu
    vhi = torch.where(swap[..., None], w_, u)
    vlo = torch.where(swap[..., None], u, w_)
    whi = torch.where(swap, lw, lu)
    wlo = torch.where(swap, lu, lw)

    alow = anchor_low[..., None]
    v0 = torch.where(alow, vhi, va)
    v1 = torch.where(alow, vlo, vhi)
    v2 = torch.where(alow, va, vlo)
    w0 = torch.where(anchor_low, whi, la)
    w1 = torch.where(anchor_low, wlo, whi)
    w2 = torch.where(anchor_low, la, wlo)
    V = torch.stack([v0, v1, v2], dim=-1)
    w = torch.stack([w0, w1, w2], dim=-1)
    return w, V


def svd3x3(F):
    """Batched SVD of ``(..., 3, 3)`` through :func:`eigh3x3_descending`
    of ``F^T F``.  Returns ``(U, s, Vt)``, ``s`` descending."""
    G = F.transpose(-1, -2) @ F
    w, V = eigh3x3_descending(G)
    s = torch.sqrt(torch.clamp(w, min=0.0))
    FV = F @ V
    dtype = F.dtype
    u0 = FV[..., :, 0] / torch.clamp(s[..., 0:1], min=1e-30)
    n0 = torch.linalg.vector_norm(u0, dim=-1, keepdim=True)
    u0 = torch.where(
        n0 > 1e-20, u0 / torch.clamp(n0, min=1e-30), _vec3([1.0, 0.0, 0.0], F)
    )
    u1 = FV[..., :, 1] / torch.clamp(s[..., 1:2], min=1e-30)
    u1 = u1 - torch.sum(u0 * u1, dim=-1, keepdim=True) * u0
    n1 = torch.linalg.vector_norm(u1, dim=-1, keepdim=True)
    ex = _vec3([0.0, 1.0, 0.0], F).expand_as(u0)
    ey = _vec3([0.0, 0.0, 1.0], F).expand_as(u0)
    fill = torch.where(torch.abs(u0[..., 1:2]) < 0.9, ex, ey)
    fill = fill - torch.sum(u0 * fill, dim=-1, keepdim=True) * u0
    fill = fill / torch.clamp(
        torch.linalg.vector_norm(fill, dim=-1, keepdim=True), min=1e-30
    )
    eps1 = 100.0 * torch.finfo(dtype).eps
    ok1 = s[..., 1:2] > eps1 * torch.clamp(s[..., 0:1], min=1e-30)
    u1 = torch.where(ok1, u1 / torch.clamp(n1, min=1e-30), fill)
    u2 = torch.linalg.cross(u0, u1)
    sgn = torch.sum(FV[..., :, 2] * u2, dim=-1, keepdim=True)
    u2 = u2 * torch.where(sgn < 0, -1.0, 1.0).to(dtype)
    U = torch.stack([u0, u1, u2], dim=-1)
    return U, s, V.transpose(-1, -2)


def inv3x3(M):
    """Closed-form (adjugate) inverse of ``(..., 3, 3)`` matrices."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
            torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
            torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]


def fundamental_from_cameras(P0, P1):
    """Fundamental matrix of a camera pair ``(..., 3, 4) x 2``:
    ``F = [P1 C]_x P1 P0^+`` with ``C`` the null vector of ``P0``."""
    _, _, Vt = torch.linalg.svd(P0)
    C = Vt[..., 3, :]
    ep = torch.einsum("...ij,...j->...i", P1, C)
    P0T = P0.transpose(-1, -2)
    invP0 = P0T @ inv3x3(P0 @ P0T)
    return skew_symmetric(ep) @ P1 @ invP0
