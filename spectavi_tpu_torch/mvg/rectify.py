"""Epipolar image-pair rectification as one batched gather.

Port of ``spectavi_tpu/mvg/rectify.py``: per output row ``r`` (from
``-extra`` to ``H + extra``) the epipolar line in image 0 is
``F^T (0, r, 1)``, its first sample seeds the line ``F seed`` in image
1, sample x-positions are ``linspace(0, W-1, round(sf*W))``, lookups are
nearest-neighbour with C-style truncation, out-of-bounds samples read 0
(image) / -1 (index map), and index maps hold ``y*W + x``.
"""

from __future__ import annotations

import numpy as np
import torch

from spectavi_tpu_torch import resolve_device
from spectavi_tpu_torch.mvg.core import fundamental_from_cameras


def _resample_lines(im, xx, yy, W, H):
    """Nearest-neighbour sample ``im (H, W, C)`` at ``xx (S,)``,
    ``yy (R, S)``.  Returns ``(vals (R, S, C), idx (R, S))``."""
    xi = torch.trunc(xx).to(torch.int32)
    yi = torch.trunc(yy).to(torch.int32)
    valid = (xi[None, :] >= 0) & (xi[None, :] < W) & (yi >= 0) & (yi < H)
    xc = torch.clamp(xi, 0, W - 1).long()
    yc = torch.clamp(yi, 0, H - 1).long()
    vals = im[yc, xc[None, :].expand_as(yc)]
    vals = torch.where(valid[..., None], vals, torch.zeros_like(vals))
    idx = torch.where(valid, yi * W + xi[None, :], torch.full_like(yi, -1))
    return vals, idx


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


def rectify_pair(P0, P1, im0, im1, sampling_factor=1.2):
    """Rectify an image pair along epipolar lines (tensor API).

    ``P0, P1 (3, 4)``, ``im0, im1 (H, W, C)`` float tensors on one
    device.  Returns ``(r0, r1, idx0, idx1)`` of shapes
    ``(H + 2*extra, S, C)`` / ``(H + 2*extra, S)`` with
    ``S = int(sampling_factor * W)`` and ``extra = max(H, W*C) // 2``.
    """
    H, W, C = im0.shape
    extra, S, F, xx = _geometry(P0, P1, H, W, C, sampling_factor)
    rows = torch.arange(-extra, H + extra, dtype=P0.dtype, device=P0.device)
    yy0, yy1 = _epipolar_yy(F, rows, xx)
    r0, idx0 = _resample_lines(im0, xx, yy0, W, H)
    r1, idx1 = _resample_lines(im1, xx, yy1, W, H)
    return r0, r1, idx0, idx1


def _rectify_pair_host(P0, P1, im0, im1, sampling_factor):
    """float64 CPU rectification of numpy images ``(H, W, C)``: same
    semantics as :func:`rectify_pair`, numpy outputs."""
    H, W, C = im0.shape
    F = fundamental_from_cameras(
        torch.as_tensor(P0, dtype=torch.float64), torch.as_tensor(P1, dtype=torch.float64)
    ).numpy()
    extra = int(max(H, W * C) / 2.0)
    S = int(sampling_factor * W)
    rows = np.arange(-extra, H + extra, dtype=np.float64)
    origins = np.stack([np.zeros_like(rows), rows, np.ones_like(rows)], -1)
    lines0 = origins @ F
    xx = np.linspace(0.0, W - 1.0, S)
    yy0 = (-lines0[:, 2:3] - lines0[:, 0:1] * xx[None, :]) / lines0[:, 1:2]
    seeds = np.stack([np.full_like(rows, xx[0]), yy0[:, 0], np.ones_like(rows)], -1)
    lines1 = seeds @ F.T
    yy1 = (-lines1[:, 2:3] - lines1[:, 0:1] * xx[None, :]) / lines1[:, 1:2]

    def resample(im, yy):
        xi = np.trunc(xx).astype(np.int32)
        yi = np.trunc(yy).astype(np.int32)
        valid = (xi[None, :] >= 0) & (xi[None, :] < W) & (yi >= 0) & (yi < H)
        lin = yi * W + xi[None, :]
        vals = im.reshape(-1, C)[np.where(valid, lin, 0)]
        vals[~valid] = 0.0
        idx = np.where(valid, lin, -1).astype(np.int32)
        return vals, idx

    r0, i0 = resample(im0, yy0)
    r1, i1 = resample(im1, yy1)
    return r0, r1, i0, i1


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
    dev = resolve_device(device)
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


def image_pair_rectification(P0, P1, im0, im1, sampling_factor=1.2, crop_invalid=True):
    """Reference-API rectification (float64 on the CPU), cropped to the
    ``idx != -1`` bounding box."""
    im0 = np.asarray(im0)
    im1 = np.asarray(im1)
    if im0.shape != im1.shape:
        raise TypeError("Input images must have same size.")
    squeeze = im0.ndim == 2
    if squeeze:
        im0 = im0[..., None]
        im1 = im1[..., None]
    r0, r1, ri0, ri1 = _rectify_pair_host(
        np.asarray(P0, dtype=np.float64), np.asarray(P1, dtype=np.float64),
        im0, im1, float(sampling_factor),
    )
    if squeeze:
        r0, r1 = r0[..., 0], r1[..., 0]
    if crop_invalid:
        idx = (ri0 != -1) | (ri1 != -1)
        y, x = np.where(idx)
        lowy, highy = y.min(), y.max()
        lowx, highx = x.min(), x.max()
        r0 = r0[lowy : highy + 1, lowx : highx + 1, ...]
        r1 = r1[lowy : highy + 1, lowx : highx + 1, ...]
        ri0 = ri0[lowy : highy + 1, lowx : highx + 1]
        ri1 = ri1[lowy : highy + 1, lowx : highx + 1]
    return r0, r1, ri0, ri1
