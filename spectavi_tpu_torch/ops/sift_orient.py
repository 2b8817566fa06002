"""SIFT orientation histograms: CUDA kernel and plain version.

Replaces the Pallas kernel
``spectavi_tpu/ops/sift_orient.py::sift_orient_hist_pallas``.  For each
candidate keypoint, a 36-bin histogram of gradient orientations over
the square window of radius ``radius`` centred on ``round(kp)`` and
clipped to the octave (the window of the JAX package's plain route,
``features/sift.py::orientations``): weight ``mod * exp(-r^2 /
(2 sigma_w^2))`` with ``sigma_w = 1.5 sigma``, pixels counted while
``r^2 < Wr^2 + 0.6`` with ``Wr = max(floor(3 sigma_w), 1)``, bin
``floor(36 ang / 2pi) mod 36``.  Invalid rows give zeros.

The Pallas kernel reads an aligned 56x256 patch whose left margin can
be 19 px, one short of the largest ``Wr`` (20), so it drops a few
pixels of the largest-scale keypoints; this port reads the exact
window.

Divisions by the constant 2pi take a tensor divisor: PyTorch's CUDA
division by a Python scalar multiplies by its reciprocal, which rounds
differently from the kernel's (and XLA's) true division and would move
pixels across bin edges.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from spectavi_tpu_torch.ops import _build

NBINS = 36
TWO_PI = 2.0 * np.pi
MAX_ANGLES = 4

launches = 0

_ROW_CHUNK = 4096


def _const(v, like):
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def window_gather(level_arr, is_, yc, xc, radius):
    """Square windows from ``level_arr (L, H, W)`` around integer centres
    ``yc, xc (K,)`` on levels ``is_ (K,)``.  Returns ``(vals (K, P),
    oy (P,), ox (P,), inb (K, P))`` with ``P = (2 radius + 1)^2`` in
    raster order."""
    L, H, W = level_arr.shape
    offs = torch.arange(-radius, radius + 1, device=level_arr.device)
    n = 2 * radius + 1
    ox = offs.repeat(n)
    oy = offs.repeat_interleave(n)
    yidx = yc.long()[:, None] + oy[None, :]
    xidx = xc.long()[:, None] + ox[None, :]
    inb = (yidx >= 0) & (yidx < H) & (xidx >= 0) & (xidx < W)
    lin = (is_.long()[:, None] * H + yidx.clamp(0, H - 1)) * W + xidx.clamp(0, W - 1)
    return level_arr.reshape(-1)[lin], oy, ox, inb


def orient_hist_plain(mod, ang, kx, ky, sigma, level, valid, radius):
    """Plain PyTorch orientation histograms ``(K, 36)``: ``mod, ang
    (L, H, W)`` float32 gradient levels of one octave, keypoint rows
    ``kx, ky, sigma`` (float32, octave pixels), ``level`` (int), and
    ``valid`` (bool)."""
    out = []
    two_pi = _const(TWO_PI, mod)
    for s in range(0, kx.shape[0], _ROW_CHUNK):
        cx, cy, cs = kx[s : s + _ROW_CHUNK], ky[s : s + _ROW_CHUNK], sigma[s : s + _ROW_CHUNK]
        cl, cv = level[s : s + _ROW_CHUNK], valid[s : s + _ROW_CHUNK]
        yi = torch.round(cy).to(torch.int32)
        xi = torch.round(cx).to(torch.int32)
        m, oy, ox, inb = window_gather(mod, cl, yi, xi, radius)
        a = window_gather(ang, cl, yi, xi, radius)[0]
        sigmaw = 1.5 * cs
        Wr = torch.clamp(torch.floor(3.0 * sigmaw), min=1.0)
        dy = (yi[:, None] + oy[None, :]).to(mod.dtype) - cy[:, None]
        dx = (xi[:, None] + ox[None, :]).to(mod.dtype) - cx[:, None]
        r2 = dx * dx + dy * dy
        wgt = torch.exp(-r2 / (2.0 * sigmaw[:, None] ** 2))
        sel = inb & (r2 < Wr[:, None] ** 2 + 0.6)
        contrib = torch.where(sel, m * wgt, torch.zeros_like(m))
        bins = torch.remainder(torch.floor(NBINS * a / two_pi).to(torch.int32), NBINS)
        hist = torch.stack(
            [torch.where(bins == b, contrib, torch.zeros_like(contrib)).sum(1) for b in range(NBINS)],
            dim=1,
        )
        out.append(torch.where(cv[:, None], hist, torch.zeros_like(hist)))
    if not out:
        return torch.zeros((0, NBINS), dtype=mod.dtype, device=mod.device)
    return torch.cat(out)


def orient_hist_cuda(mod, ang, kx, ky, sigma, level, valid, radius):
    """Launch ``csrc/sift_orient.cu``: same arguments and result as
    :func:`orient_hist_plain`, on CUDA tensors."""
    global launches
    if not mod.is_cuda:
        raise ValueError("orient_hist_cuda needs CUDA tensors")
    if mod.dtype != torch.float32 or ang.dtype != torch.float32:
        raise TypeError("gradient levels must be float32")
    if mod.dim() != 3 or ang.shape != mod.shape:
        raise ValueError(f"mod/ang must share one (L, H, W) shape, got {tuple(mod.shape)}/{tuple(ang.shape)}")
    mod, ang = mod.contiguous(), ang.contiguous()
    L, H, W = mod.shape
    K = kx.shape[0]
    meta = torch.stack(
        [kx, ky, sigma, level.to(torch.float32), valid.to(torch.float32)], dim=1
    ).to(device=mod.device, dtype=torch.float32).contiguous()
    out = torch.empty((K, NBINS), dtype=torch.float32, device=mod.device)
    if K == 0:
        return out
    fn = _build.load("sift_orient").sift_orient_hist
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    stream = torch.cuda.current_stream(mod.device).cuda_stream
    status = fn(mod.data_ptr(), ang.data_ptr(), L, H, W, meta.data_ptr(), K, int(radius),
                out.data_ptr(), stream)
    _build.check(status, "sift_orient_hist")
    launches += 1
    return out


def orient_hist(mod, ang, kx, ky, sigma, level, valid, radius):
    """Orientation histograms: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if mod.is_cuda:
        return orient_hist_cuda(mod, ang, kx, ky, sigma, level, valid, radius)
    return orient_hist_plain(mod, ang, kx, ky, sigma, level, valid, radius)


def orientation_peaks(hist, kp_valid):
    """vlfeat orientation post-processing on raw 36-bin histograms: 6x
    circular box smoothing, peaks >= 0.8 max with parabolic refinement,
    up to 4 angles in ascending bin order.  ``hist (K, 36)`` ->
    ``(angles (K, 4), avalid (K, 4))``."""
    for _ in range(6):
        hist = (torch.roll(hist, 1, 1) + hist + torch.roll(hist, -1, 1)) / 3.0
    hmax = hist.amax(1, keepdim=True)
    hp = torch.roll(hist, -1, 1)
    hm = torch.roll(hist, 1, 1)
    is_peak = (hist > hm) & (hist > hp) & (hist >= 0.8 * hmax)
    binidx = torch.arange(NBINS, device=hist.device)[None, :].expand_as(hist)
    order_key = torch.where(is_peak, binidx, NBINS + 1)
    # values only, so the order among equal keys does not matter
    sel_bins = -torch.topk(-order_key, MAX_ANGLES, dim=1).values
    avalid = sel_bins <= NBINS
    sel_bins = torch.clamp(sel_bins, 0, NBINS - 1)
    h0 = hist.gather(1, sel_bins)
    hpk = hp.gather(1, sel_bins)
    hmk = hm.gather(1, sel_bins)
    denom = hpk + hmk - 2.0 * h0
    safe = torch.abs(denom) > 1e-20
    di = torch.where(safe, -0.5 * (hpk - hmk) / torch.where(safe, denom, 1.0), 0.0)
    th = torch.remainder(TWO_PI * (sel_bins + di + 0.5) / NBINS, TWO_PI)
    return th, avalid & kp_valid[:, None]
