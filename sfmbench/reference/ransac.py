"""RANSAC of the plain reference.

Frozen copies of the port's plain PyTorch RANSAC
(``spectavi_tpu_torch/mvg/ransac.py``: the essential-matrix fitter
that ex01's step 3 loops and the batched core of the pair step, with
``mvg/sevenpoint.py``'s 7-point solver and ``mvg/core.py``'s closed-form
3x3 SVD).  Handed a ``torch.Generator`` with the seed the program's
job was given, on the same device, the reference draws the same sample
tables and so replays the program's search: the consensus it reaches
is what the program's has to match.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sfmbench.reference.geometry import triangulate_fast_full
from sfmbench.reference.ops import _det3


def seeded_generator(generator, device):
    """``generator`` itself, or a new one on ``device`` with seed 0."""
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    return generator


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


DEFAULT_OPTIONS = {
    "required_percent_inliers": 0.9,
    "reprojection_error_allowed": 0.5,
    "maximum_tries": 500,
    "find_best_even_in_failure": True,
    "singular_value_ratio_allowed": 3e-2,
}


def sample_subsets(n, trials, point_mask, generator=None):
    """``(trials, 7)`` index samples without replacement from the rows
    where ``point_mask`` is set: uniform keys, then 7 masked argmins."""
    device = point_mask.device
    u = torch.rand((trials, n), generator=generator, device=device)
    u = torch.where(point_mask[None, :], u, torch.full_like(u, float("inf")))
    rows = torch.arange(trials, device=device)
    idxs = []
    for _ in range(7):
        i = torch.argmin(u, dim=1)
        idxs.append(i)
        u[rows, i] = float("inf")
    return torch.stack(idxs, dim=1)


def _diag110(like):
    return torch.diag(torch.tensor([1.0, 1.0, 0.0], dtype=like.dtype, device=like.device))


def _sampson_counts(F, valid, x0, x1, point_mask, reproj_allowed, svr_allowed, chunk=1024):
    """Sampson inlier counts for ranking hypotheses.

    ``F (..., T, 3, 3, 3)``, ``valid (..., T, 3)`` over correspondences
    ``x0, x1 (..., N, 2)`` -> ``(counts (..., T, 3), gate (..., T, 3))``:
    counts of every valid root (-1 where the 7-point solve failed) and
    the reference's singular-value-ratio + validity gate.  Trials are
    scored at most ``chunk`` at a time, fewer when the leading batch is
    wide, to bound memory; each trial's count is independent of the
    chunking."""
    thr2 = (0.5 * reproj_allowed) ** 2
    x0h = torch.cat([x0, torch.ones_like(x0[..., :1])], dim=-1)
    x1h = torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1)
    D = _diag110(F)
    pm = point_mask[..., None, None, :]
    lead = int(np.prod(F.shape[:-4]))
    chunk = max(1, min(chunk, (1 << 27) // max(1, lead * 9 * x0.shape[-2])))
    counts, gates = [], []
    for s in range(0, F.shape[-4], chunk):
        Ft, validt = F[..., s : s + chunk, :, :, :], valid[..., s : s + chunk, :]
        U, S, Vt = svd3x3(Ft)
        ratio = torch.abs(S[..., 0] - S[..., 1]) / (torch.abs(S[..., 0] + S[..., 1]) / 2.0)
        gate = (ratio <= svr_allowed) & validt
        E = U @ D @ Vt
        Ex0 = torch.einsum("...trij,...nj->...trni", E, x0h)
        Etx1 = torch.einsum("...trji,...nj->...trni", E, x1h)
        xEx = torch.einsum("...ni,...trni->...trn", x1h, Ex0)
        denom = Ex0[..., 0] ** 2 + Ex0[..., 1] ** 2 + Etx1[..., 0] ** 2 + Etx1[..., 1] ** 2
        sampson2 = (xEx * xEx) / torch.clamp(denom, min=1e-30)
        inlier = (sampson2 <= thr2) & pm
        c = inlier.sum(-1).to(torch.int32)
        counts.append(torch.where(validt, c, torch.full_like(c, -1)))
        gates.append(gate)
    return torch.cat(counts, dim=-2), torch.cat(gates, dim=-2)


def _rescore_best(F, x0, x1, point_mask, reproj_allowed):
    """Re-score ``F (..., K, 3, 3)``: best of each one's 4 cameras under
    the exact criterion, over ``x0, x1 (..., N, 2)``.  Returns ``(cams
    (..., K, 3, 4), counts (..., K), masks (..., K, N))``."""
    P0 = identity_camera(x0.dtype, x0.device)
    U, S, Vt = svd3x3(F)
    P1s = cameras_from_svd(U, Vt)  # (..., K, 4, 3, 4)
    _, reproj, infront = triangulate_fast_full(
        P0, P1s[..., None, :, :], x0[..., None, None, :, :], x1[..., None, None, :, :]
    )
    inlier = (reproj <= reproj_allowed) & infront & point_mask[..., None, None, :]  # (..., K, 4, N)
    counts = inlier.sum(-1).to(torch.int32)
    ic = torch.argmax(counts, dim=-1)  # (..., K)
    cams = torch.take_along_dim(P1s, ic[..., None, None, None], dim=-3)[..., 0, :, :]
    cnt = torch.take_along_dim(counts, ic[..., None], dim=-1)[..., 0]
    msk = torch.take_along_dim(inlier, ic[..., None, None], dim=-2)[..., 0, :]
    return cams, cnt, msk


def _cg_solve9(G, b, iters=16):
    """Solve ``G x = b`` for batched 9x9 SPD ``G`` by unrolled CG."""
    x = torch.zeros_like(b)
    r = b
    p = b
    rs = torch.sum(r * r, dim=-1, keepdim=True)
    for _ in range(iters):
        Ap = torch.einsum("bij,bj->bi", G, p)
        alpha = rs / torch.clamp(torch.sum(p * Ap, dim=-1, keepdim=True), min=1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = torch.sum(r * r, dim=-1, keepdim=True)
        p = r + (rs_new / torch.clamp(rs, min=1e-30)) * p
        rs = rs_new
    return x


def _lo_refine_step(x0, x1, weights, reproj_allowed, weight_allowed, point_mask, F_init):
    """One LO-RANSAC step for a batch of seeds: weighted 8-point refit
    (ridged inverse iteration with a CG inner solve, warm-started from
    ``F_init (B, 3, 3)``), projection to an essential matrix, camera
    re-selection and full re-score.  ``weights (B, N)``."""
    u, v = x0[:, 0], x0[:, 1]
    up, vp = x1[:, 0], x1[:, 1]
    one = torch.ones_like(u)
    A = torch.stack([up * u, up * v, up, vp * u, vp * v, vp, u, v, one], dim=-1)
    A = A[None] * weights[:, :, None]  # (B, N, 9)
    G = A.transpose(1, 2) @ A
    tr = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)
    G = G / torch.clamp(tr, min=1e-30)[:, None, None]
    G = G + (100.0 * torch.finfo(x0.dtype).eps) * torch.eye(9, dtype=x0.dtype, device=x0.device)
    f = F_init.reshape(-1, 9)
    f = f / torch.clamp(torch.linalg.vector_norm(f, dim=-1, keepdim=True), min=1e-30)
    for _ in range(2):
        f = _cg_solve9(G, f)
        f = f / torch.clamp(torch.linalg.vector_norm(f, dim=-1, keepdim=True), min=1e-30)
    F = f.reshape(-1, 3, 3)
    U3, S3, Vt3 = svd3x3(F)
    E = U3 @ _diag110(F) @ Vt3
    P1 = cameras_from_svd(U3, Vt3)  # (B, 4, 3, 4)
    P0 = identity_camera(x0.dtype, x0.device)
    _, reproj, infront = triangulate_fast_full(P0, P1[:, :, None], x0, x1)
    inlier = (reproj <= reproj_allowed) & infront & point_mask  # (B, 4, N)
    loose = (reproj <= weight_allowed) & infront & point_mask
    counts = inlier.sum(-1).to(torch.int32)
    ic = torch.argmax(counts, dim=1)
    b = torch.arange(F.shape[0], device=F.device)
    return E, P1[b, ic], counts[b, ic], inlier[b, ic], loose[b, ic]


def _trial_table(generator, n, trials, point_mask, sample, name):
    """The ``(..., trials, 7)`` sample table: ``sample`` as given (its
    length must be ``trials``), or one table per leading problem of
    ``point_mask (..., n)`` drawn from ``generator`` in turn (seed 0
    when it is None)."""
    trials = int(trials)
    if sample is not None:
        if sample.shape[-2] != trials:
            raise ValueError(f"{name} = {trials}, but the sample table has "
                             f"{sample.shape[-2]} trials")
        return sample
    generator = seeded_generator(generator, point_mask.device)
    flat = point_mask.reshape(-1, n)
    tables = torch.stack([sample_subsets(n, trials, m, generator) for m in flat])
    return tables.reshape(*point_mask.shape[:-1], trials, 7)


def ransac_fit_block(generator, x0, x1, point_mask, reproj_allowed, svr_allowed,
                     live_trials, batch_trials=2048, lo_iters=3, *, sample=None):
    """One block of RANSAC trials + shortlist re-score + LO refinement.

    ``batch_trials`` 7-point samples of the ``(N, 2)`` correspondences
    ``x0, x1`` are drawn from ``generator`` (a ``torch.Generator``, or
    None for one with seed 0), or handed in as ``sample (batch_trials,
    7)`` row indices, when ``generator`` is unused; ``point_mask (N,)``
    marks real rows; only
    the first ``live_trials`` trials may win.  Returns ``(essential,
    camera, count, inlier_mask)`` (tensors); ``count`` is -1 when no
    root passed the reference gate and no LO seed produced a model.
    """
    N = x0.shape[0]
    sample = _trial_table(generator, N, batch_trials, point_mask, sample, "batch_trials")
    T = sample.shape[0]
    F, valid = seven_point(x0[sample], x1[sample], nullspace="mgs")
    live = torch.arange(T, device=x0.device) < live_trials
    counts, gate = _sampson_counts(
        F, valid & live[:, None], x0, x1, point_mask, reproj_allowed, svr_allowed
    )
    flat_counts = counts.reshape(-1)
    flat_gate = gate.reshape(-1)

    k_seeds = 16
    seed_key = flat_counts + torch.where(flat_gate, N + 2, 0).to(flat_counts.dtype)
    # lax.top_k order: descending, ties to the lower index
    top_i = torch.sort(seed_key, descending=True, stable=True)[1][:k_seeds]
    it, ir = top_i // 3, top_i % 3
    okb = flat_gate[top_i]
    validb = flat_counts[top_i] >= 0
    muls = (2.0, 1.4, 1.0)

    Fb = F[it, ir]  # (k, 3, 3)
    cam0, cnt0, msk0 = _rescore_best(Fb, x0, x1, point_mask, reproj_allowed)
    best_E, best_cam = Fb, cam0
    best_cnt = torch.where(okb, cnt0, torch.full_like(cnt0, -1))
    best_msk = msk0 & okb[:, None]
    Fcur = Fb
    wsel = msk0 & validb[:, None]
    enough = validb & (cnt0 >= 8)
    for m in muls[:lo_iters]:
        E2, P2, c2, m2, loose2 = _lo_refine_step(
            x0, x1, wsel.to(x0.dtype), reproj_allowed, reproj_allowed * m,
            point_mask, Fcur,
        )
        c2 = torch.where(enough, c2, torch.full_like(c2, -1))
        better = c2 > best_cnt
        best_E = torch.where(better[:, None, None], E2, best_E)
        best_cam = torch.where(better[:, None, None], P2, best_cam)
        best_cnt = torch.maximum(best_cnt, c2)
        best_msk = torch.where(better[:, None], m2, best_msk)
        Fcur = torch.where(enough[:, None, None], E2, Fcur)
        wsel = torch.where(enough[:, None], loose2, wsel)
    bi = torch.argmax(best_cnt)
    return best_E[bi], best_cam[bi], best_cnt[bi], best_msk[bi]


def _gather_rows(x, idx):
    """``x (..., N, d)`` rows at ``idx (..., m)`` -> ``(..., m, d)``."""
    return torch.take_along_dim(x, idx[..., None], dim=-2)


def ransac_essential_core(generator, x0, x1, trials, reproj_allowed, svr_allowed,
                          point_mask=None, *, sample=None):
    """One batch of RANSAC trials; the batch winner.

    ``trials`` 7-point samples of the euclidean correspondences ``x0,
    x1 (..., N, 2)`` are drawn from ``generator`` (a
    ``torch.Generator``, or None for one with seed 0; one table per
    problem in turn), or handed in as ``sample (..., trials, 7)`` row
    indices, when ``generator`` is unused; ``point_mask (..., N)`` marks
    real rows.  Leading dimensions
    are independent problems (the pair step's pairs).  The 7-point roots
    are ranked by their Sampson counts under the reference gate, the top
    8 (stable: ties to the lower index, as ``lax.top_k``) are re-scored
    under the exact criterion, and the best wins.  Returns a dict of ``essential (...,
    3, 3)``, ``camera (..., 3, 4)``, ``count (...)`` (-1 when every
    hypothesis failed the gate) and ``inlier_mask (..., N)``."""
    N = x0.shape[-2]
    if point_mask is None:
        point_mask = torch.ones(x0.shape[:-1], dtype=torch.bool, device=x0.device)
    sample = _trial_table(generator, N, trials, point_mask, sample, "trials")
    lead, T = sample.shape[:-2], sample.shape[-2]
    flat_s = sample.reshape(*lead, T * 7)
    xs0 = _gather_rows(x0, flat_s).reshape(*lead, T, 7, 2)
    xs1 = _gather_rows(x1, flat_s).reshape(*lead, T, 7, 2)
    F, valid = seven_point(xs0, xs1, nullspace="mgs")
    counts, gate = _sampson_counts(F, valid, x0, x1, point_mask, reproj_allowed, svr_allowed)
    counts = torch.where(gate, counts, torch.full_like(counts, -1))
    flat = counts.reshape(*lead, T * 3)
    k_rank = min(8, T * 3)
    topv, top_i = torch.sort(flat, dim=-1, descending=True, stable=True)
    topv, top_i = topv[..., :k_rank], top_i[..., :k_rank]
    Fk = torch.take_along_dim(F.reshape(*lead, T * 3, 3, 3), top_i[..., None, None], dim=-3)
    cams, cnts, msks = _rescore_best(Fk, x0, x1, point_mask, reproj_allowed)
    cnts = torch.where(topv >= 0, cnts, torch.full_like(cnts, -1))
    bi = torch.argmax(cnts, dim=-1, keepdim=True)  # (..., 1)
    best = torch.take_along_dim(cnts, bi, dim=-1)[..., 0]
    best_ok = best >= 0
    return {
        "essential": torch.take_along_dim(Fk, bi[..., None, None], dim=-3)[..., 0, :, :],
        "camera": torch.take_along_dim(cams, bi[..., None, None], dim=-3)[..., 0, :, :],
        "count": torch.where(best_ok, best, torch.full_like(best, -1)),
        "inlier_mask": torch.take_along_dim(msks, bi[..., None], dim=-2)[..., 0, :]
        & best_ok[..., None],
    }


def ransac_fitter(x0, x1, options=None, generator=None, batch_trials=8192,
                  confidence=0.999, device="cuda"):
    """Fit a two-view essential matrix to tentative correspondences.

    Same options and return dict as the JAX package's ``ransac_fitter``
    (``success``, ``essential``, ``camera``, ``inlier_percent``,
    ``inlier_idx``, numpy values).  ``generator`` (a ``torch.Generator``
    on ``device``) draws the sample tables; ``None`` seeds one with 0.
    The geometry runs in float32 on CUDA (the accelerator's working
    type) and in the input's float type on the CPU.  Blocks run one at
    a time; the loop stops on the required count, on ``maximum_tries``
    or on the ``confidence`` rule, exactly as the JAX fitter does.
    """
    dev = torch.device(device)
    opts = dict(DEFAULT_OPTIONS)
    if options:
        opts.update(options)
    x0 = np.asarray(x0)
    x1 = np.asarray(x1)
    if x0.shape[0] != x1.shape[0]:
        raise ValueError("Supplied incorrect point matches, numbers do not match.")
    if x0.shape[0] < 10:
        raise ValueError("Supplied less than 10 point matches, unsupported.")
    if x0.shape[1] == 3:
        x0 = x0[:, :2] / x0[:, 2:]
    if x1.shape[1] == 3:
        x1 = x1[:, :2] / x1[:, 2:]
    on_cpu64 = dev.type == "cpu" and x0.dtype == np.float64
    dtype = torch.float64 if on_cpu64 else torch.float32
    generator = seeded_generator(generator, dev)

    N = x0.shape[0]
    required = opts["required_percent_inliers"]
    max_tries = int(opts["maximum_tries"])
    batch_trials = min(
        batch_trials, max(512, 1 << int(np.ceil(np.log2(max(max_tries, 2)))))
    )
    Np = max(16, 1 << (N - 1).bit_length())
    pmask = torch.zeros(Np, dtype=torch.bool, device=dev)
    pmask[:N] = True
    x0t = torch.zeros((Np, 2), dtype=dtype, device=dev)
    x1t = torch.zeros((Np, 2), dtype=dtype, device=dev)
    x0t[:N] = torch.as_tensor(x0, dtype=dtype, device=dev)
    x1t[:N] = torch.as_tensor(x1, dtype=dtype, device=dev)
    reproj = float(opts["reprojection_error_allowed"])
    svr = float(opts["singular_value_ratio_allowed"])
    lo_iters = 3 if opts.get("local_optimization", True) else 0
    required_count = int(np.ceil(required * N))

    best = None
    best_count = -1
    tries = 0
    stalled = 0
    while tries < max_tries:
        live = min(batch_trials, max_tries - tries)
        out = ransac_fit_block(
            generator, x0t, x1t, pmask, reproj, svr, live, batch_trials, lo_iters
        )
        count = int(out[2])
        if count > best_count + max(2, int(0.005 * N)):
            stalled = 0
        else:
            stalled += 1
        if count > best_count:
            best_count = count
            best = out
        tries += live
        if best_count >= required_count:
            break
        w = max(best_count, 0) / N
        if w > 0 and (stalled >= 2 or tries >= 8 * batch_trials):
            needed = math.log(1.0 - confidence) / math.log1p(-min(w**7, 1.0 - 1e-12))
            if tries >= needed:
                break
    if best is None or best_count < 0:
        return {
            "success": False,
            "essential": np.zeros((3, 3)),
            "camera": np.zeros((3, 4)),
            "inlier_percent": 0.0,
            "inlier_idx": np.zeros((0,), np.int32),
        }
    essential, camera, _, mask = best
    success = best_count / N >= required
    if not success and not opts["find_best_even_in_failure"]:
        return {
            "success": False,
            "essential": np.zeros((3, 3)),
            "camera": np.zeros((3, 4)),
            "inlier_percent": best_count / N,
            "inlier_idx": np.zeros((0,), np.int32),
        }
    mask = mask.cpu().numpy()
    return {
        "success": bool(success),
        "essential": essential.cpu().numpy(),
        "camera": camera.cpu().numpy(),
        "inlier_percent": best_count / N,
        "inlier_idx": np.where(mask[:N])[0].astype(np.int32),
    }


def pair_step(descs, pts_cal, pair_list, generator, reproj_allowed, svr_allowed, min_ratio,
              trials=8192, pad_to=256, compact_to=4096, fit=True):
    """ex02's batched pair step (a frozen copy of
    ``pipeline/sfm.py::_match_pairs_batched`` and the masked one-device
    step of ``parallel/two_view.py``), its exact top-2 by the plain
    matcher, with the same padding and compaction.  ``descs``: per-view
    quantized uint8 tables on one device; ``pts_cal``: per-view
    calibrated ``(n, 2)`` float64.  Returns ``{(i, j): {"n_matches",
    "idx_i", "idx_j"}}`` (a pair with an empty view left out): with
    ``fit``, RANSAC's inliers and ``"camera"``; without it, the
    compacted ratio-test survivors that RANSAC would see."""
    from sfmbench.reference.ops import l2_topk_mxu

    dev = descs[0].device
    pair_list = [(i, j) for (i, j) in pair_list if descs[i].shape[0] and descs[j].shape[0]]
    if not pair_list:
        return {}
    B = len(pair_list)

    def ceil_to(n, m):
        return ((n + m - 1) // m) * m

    X = max(ceil_to(max(descs[i].shape[0] for i, _ in pair_list), pad_to), pad_to)
    Y = max(ceil_to(max(descs[j].shape[0] for _, j in pair_list), pad_to), pad_to)
    D = descs[0].shape[1]
    p0 = np.zeros((B, X, 2), np.float32)
    p1 = np.zeros((B, Y, 2), np.float32)
    nx = np.zeros(B, np.int64)
    ny = np.zeros(B, np.int64)
    for b, (i, j) in enumerate(pair_list):
        nx[b], ny[b] = descs[i].shape[0], descs[j].shape[0]
        p0[b, : nx[b]] = pts_cal[i].astype(np.float32)
        p1[b, : ny[b]] = pts_cal[j].astype(np.float32)

    def pad_rows(d, rows, replicate):
        fill = d[:1].expand(rows - d.shape[0], D) if replicate else d.new_zeros((rows - d.shape[0], D))
        return torch.cat([d, fill], dim=0)

    d0 = torch.stack([pad_rows(descs[i], X, True) for i, _ in pair_list])
    d1 = torch.stack([pad_rows(descs[j], Y, False) for _, j in pair_list])
    pts0 = torch.as_tensor(p0, device=dev)
    pts1 = torch.as_tensor(p1, device=dev)
    nx_t = torch.as_tensor(nx, device=dev)
    ny_t = torch.as_tensor(ny, device=dev)
    idx, dist = (torch.stack(t) for t in zip(*(l2_topk_mxu(d0[b], d1[b], k=2)
                                              for b in range(B))))
    idx = idx.long()
    d1s = torch.clamp(dist[..., 0].to(pts0.dtype), min=1e-12)
    d2s = dist[..., 1].to(pts0.dtype)
    qi = torch.arange(Y, device=dev)
    ratio_ok = ((d2s >= (min_ratio**2) * d1s) & (idx[..., 0] < nx_t[:, None])
                & (qi[None] < ny_t[:, None]))
    C = min(compact_to, Y)
    margin = torch.where(ratio_ok, d2s / d1s, torch.full_like(d1s, -1.0))
    topq = torch.sort(margin, dim=1, descending=True, stable=True).indices[:, :C]
    cmask = torch.gather(ratio_ok, 1, topq)
    if fit:
        src = torch.gather(idx[..., 0], 1, topq)
        x0 = torch.take_along_dim(pts0, src[..., None], dim=1)
        x1 = torch.take_along_dim(pts1, topq[..., None], dim=1)
        out = ransac_essential_core(generator, x0, x1, trials, reproj_allowed, svr_allowed,
                                    cmask)
        keep = torch.zeros((B, Y), dtype=torch.bool, device=dev)
        keep.scatter_(1, topq, out["inlier_mask"])
        cams = out["camera"].cpu().numpy()
    else:
        keep = torch.zeros((B, Y), dtype=torch.bool, device=dev)
        keep.scatter_(1, topq, cmask)
    keep, midx0, ratio_ok = (t.cpu().numpy() for t in (keep, idx[..., 0], ratio_ok))
    res = {}
    for b, (i, j) in enumerate(pair_list):
        kj = np.where(keep[b, : ny[b]])[0].astype(np.int64)
        res[(i, j)] = {"n_matches": int(ratio_ok[b, : ny[b]].sum()),
                       "idx_i": midx0[b, kj].astype(np.int64), "idx_j": kj}
        if fit:
            res[(i, j)]["camera"] = cams[b]
    return res
