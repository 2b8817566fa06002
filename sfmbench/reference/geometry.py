"""Two-view geometry of the plain reference.

Frozen copies of the port's plain PyTorch geometry
(``spectavi_tpu_torch/mvg/triangulate.py``: the DLT triangulation and
the scoring triangulation whose reprojection and cheirality decide a
RANSAC inlier; ``spectavi_tpu_torch/mvg/rectify.py``: the card's
rectification, float32 line geometry and uint8 pixels), and the
reference's own numpy pose and trajectory measures.
"""

from __future__ import annotations

import numpy as np
import torch

from sfmbench.reference.ops import _det3, fundamental_from_cameras, hnormalize, inv3x3

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


def _epipolar_yy(F, rows_vals, xx):
    """Per-row epipolar sample y-coordinates ``(yy0, yy1)`` of shape
    ``(R, S)`` in both images (``rows_vals (R,)``, ``xx (S,)``)."""
    ones = torch.ones_like(rows_vals)
    zeros = torch.zeros_like(rows_vals)

    def line_y(lines):
        # y = (-l2 - l0 x) / l1, the numerator as one fused multiply-add
        # (as XLA computes it), so truncated indices match the JAX package
        return torch.addcmul(-lines[:, 2:3], -lines[:, 0:1], xx[None, :]) / lines[:, 1:2]

    yy0 = line_y(torch.stack([zeros, rows_vals, ones], dim=-1) @ F)
    seeds = torch.stack([torch.full_like(rows_vals, float(xx[0])), yy0[:, 0], ones], dim=-1)
    return yy0, line_y(seeds @ F.T)


def _linspace(stop, num, like):
    """``linspace(0, stop, num)`` with the JAX package's float32 values:
    XLA folds ``stop * (i / div)`` into ``i * (stop * (1 / div))``,
    which for some widths (160: 1 -> 0.99999994) falls an ulp below the
    integers and moves truncated sample columns.  The port keeps the
    same sample columns."""
    if num < 2:
        return torch.zeros(num, dtype=like.dtype, device=like.device)
    f = np.float32 if like.dtype == torch.float32 else np.float64
    c = float(f(f(1.0) / f(num - 1)) * f(stop))
    out = torch.arange(num - 1, dtype=like.dtype, device=like.device) * c
    return torch.cat([out, torch.full((1,), float(stop), dtype=like.dtype, device=like.device)])


def _geometry(P0, P1, H, W, C, sampling_factor):
    extra = int(max(H, W * C) / 2.0)
    S = int(sampling_factor * W)
    F = fundamental_from_cameras(P0, P1)
    return extra, S, F, _linspace(W - 1.0, S, P0)


def _rectify_row_bbox(P0, P1, shape, sampling_factor):
    """Valid-region bounding box ``(lowy, highy, lowx, highx)`` of the
    padded output canvas, from line geometry alone (no pixel gather)."""
    H, W, C = shape
    extra, S, F, xx = _geometry(P0, P1, H, W, C, sampling_factor)
    rows = torch.arange(-extra, H + extra, dtype=P0.dtype, device=P0.device)
    R = rows.shape[0]
    yy0, yy1 = _epipolar_yy(F, rows, xx)
    xi = torch.trunc(xx).to(torch.int32)
    xvalid = (xi >= 0) & (xi < W)

    def yvalid(yy):
        yi = torch.trunc(yy).to(torch.int32)
        return (yi >= 0) & (yi < H)

    valid = xvalid[None, :] & (yvalid(yy0) | yvalid(yy1))
    anyrow = valid.any(dim=1)
    anycol = valid.any(dim=0)
    rowsi = torch.arange(R, device=P0.device)
    colsi = torch.arange(S, device=P0.device)
    lowy = torch.where(anyrow, rowsi, R).min()
    highy = torch.where(anyrow, rowsi, -1).max()
    lowx = torch.where(anycol, colsi, S).min()
    highx = torch.where(anycol, colsi, -1).max()
    return torch.stack([lowy, highy, lowx, highx])


def _rectify_window(P0, P1, im0, im1, row0, scale0, scale1, Hq, sampling_factor):
    """Resample ``Hq`` output rows starting at ``row0`` and quantize to
    uint8.  Returns ``(r0 (Hq, S, C) u8, r1, y0 (Hq, S), y1, xi (S,))``
    with source y-indices (-1 where invalid) and shared x-indices."""
    H, W, C = im0.shape
    extra, S, F, xx = _geometry(P0, P1, H, W, C, sampling_factor)
    rows = (torch.arange(Hq, dtype=torch.int32, device=P0.device) + row0).to(P0.dtype) - extra
    yy0, yy1 = _epipolar_yy(F, rows, xx)
    xi = torch.trunc(xx).to(torch.int32)
    xvalid = (xi >= 0) & (xi < W)
    xc = torch.clamp(xi, 0, W - 1).long()

    def sample(im, yy, scale):
        yi = torch.trunc(yy).to(torch.int32)
        valid = xvalid[None, :] & (yi >= 0) & (yi < H)
        yc = torch.clamp(yi, 0, H - 1).long()
        vals = im[yc, xc[None, :].expand_as(yc)].to(torch.float32) * scale
        vals = torch.where(valid[..., None], vals, torch.zeros_like(vals))
        vals_u8 = torch.clamp(vals, 0.0, 255.0).to(torch.uint8)
        ysrc = torch.where(valid, yi, torch.full_like(yi, -1))
        return vals_u8, ysrc

    r0u, y0 = sample(im0, yy0, scale0)
    r1u, y1 = sample(im1, yy1, scale1)
    return r0u, r1u, y0, y1, torch.where(xvalid, xi, torch.full_like(xi, -1))


def rectify_pair_quantized(P0, P1, im0, im1, sampling_factor=1.0, device="cuda"):
    """Accelerator rectification: float32 line geometry, bounding box
    first, then a gather over the valid rows only, uint8 pixels.

    ``im0, im1`` numpy ``(H, W[, C])`` arrays, raw uint8 (pixels become
    ``clip(raw * 255/max(raw))``) or max-normalized floats (pixels
    become ``clip(x * 255)``).  Returns numpy ``(r0_u8, r1_u8, idx0,
    idx1)`` cropped to the valid region.
    """
    dev = torch.device(device)
    im0 = np.asarray(im0)
    im1 = np.asarray(im1)
    if im0.shape != im1.shape:
        raise TypeError("Input images must have same size.")
    if im0.ndim == 2:
        im0 = im0[..., None]
        im1 = im1[..., None]
    if im0.dtype == np.uint8:
        scales = tuple(
            float(np.float32(255.0) / np.float32(max(int(im.max()), 1)))
            for im in (im0, im1)
        )
    else:
        im0 = im0.astype(np.float32, copy=False)
        im1 = im1.astype(np.float32, copy=False)
        scales = (255.0, 255.0)
    H, W, C = im0.shape
    P0f = torch.as_tensor(np.asarray(P0), dtype=torch.float32, device=dev)
    P1f = torch.as_tensor(np.asarray(P1), dtype=torch.float32, device=dev)
    ly, hy, lx, hx = (
        int(v) for v in _rectify_row_bbox(P0f, P1f, (H, W, C), float(sampling_factor)).tolist()
    )
    if hy < ly or hx < lx:
        e_im = np.zeros((0, 0, C), np.uint8)
        e_idx = np.zeros((0, 0), np.int32)
        return e_im, e_im.copy(), e_idx, e_idx.copy()
    height = hy - ly + 1
    r0u, r1u, y0, y1, xi = _rectify_window(
        P0f, P1f,
        torch.as_tensor(np.ascontiguousarray(im0), device=dev),
        torch.as_tensor(np.ascontiguousarray(im1), device=dev),
        ly, scales[0], scales[1], height, float(sampling_factor),
    )
    cs = slice(lx, hx + 1)
    r0u, r1u = r0u[:, cs].cpu().numpy(), r1u[:, cs].cpu().numpy()
    xiw = xi[None, cs].cpu().numpy().astype(np.int32)
    idxs = []
    for y in (y0, y1):
        yw = y[:, cs].cpu().numpy().astype(np.int32)
        idxs.append(np.where(yw < 0, -1, yw * W + xiw))
    return r0u, r1u, idxs[0], idxs[1]


def homogeneous_calibrated(pts, K):
    """Pixel rows ``(n, >=2)`` -> calibrated euclidean ``(n, 2)``
    float64, as the pipelines normalise their matches."""
    h = np.hstack([pts[:, :2], np.ones((pts.shape[0], 1))]) @ np.linalg.inv(K).T
    return h[:, :2] / h[:, 2:]


def rodrigues_np(rvec):
    """Rotation matrices ``(n, 3, 3)`` of axis-angle rows ``(n, 3)``."""
    rvec = np.atleast_2d(np.asarray(rvec, np.float64))
    th = np.linalg.norm(rvec, axis=1)
    k = rvec / np.where(th > 1e-300, th, 1.0)[:, None]
    Kx = np.zeros((len(rvec), 3, 3))
    Kx[:, 0, 1], Kx[:, 0, 2] = -k[:, 2], k[:, 1]
    Kx[:, 1, 0], Kx[:, 1, 2] = k[:, 2], -k[:, 0]
    Kx[:, 2, 0], Kx[:, 2, 1] = -k[:, 1], k[:, 0]
    s, c = np.sin(th)[:, None, None], np.cos(th)[:, None, None]
    return np.eye(3)[None] + s * Kx + (1.0 - c) * Kx @ Kx


def camera_centres(cams):
    """Centres ``C = -R^T t`` of ``(V, 6)`` axis-angle cameras."""
    cams = np.asarray(cams, np.float64)
    R = rodrigues_np(cams[:, :3])
    return -np.einsum("vij,vi->vj", R, cams[:, 3:])


def ate_share(cams, gt_centres):
    """RMSE of the camera centres after the closed-form similarity
    (Umeyama) that best aligns them with ``gt_centres``, as a share of
    the ground-truth trajectory's widest extent."""
    src = camera_centres(cams)
    dst = np.asarray(gt_centres, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    U, D, Vt = np.linalg.svd(xd.T @ xs / len(src))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / ((xs ** 2).sum() / len(src)))
    aligned = s * xs @ R.T + mu_d
    rmse = float(np.sqrt(((aligned - dst) ** 2).sum(axis=1).mean()))
    return rmse / float(np.ptp(dst, axis=0).max())


def pose_errors_deg(camera, R_gt, t_gt):
    """Rotation angle and translation-direction angle, in degrees,
    between a camera ``[R | t]`` and the truth (the sign of ``t`` is the
    cheirality test's, so the direction is compared as it stands)."""
    R = np.asarray(camera, np.float64)[:, :3]
    t = np.asarray(camera, np.float64)[:, 3]
    c = np.clip((np.trace(R @ np.asarray(R_gt).T) - 1.0) / 2.0, -1.0, 1.0)
    rot = float(np.degrees(np.arccos(c)))
    tn = t / max(np.linalg.norm(t), 1e-300)
    tg = np.asarray(t_gt, np.float64) / np.linalg.norm(t_gt)
    return rot, float(np.degrees(np.arccos(np.clip(tn @ tg, -1.0, 1.0))))
