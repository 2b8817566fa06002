"""SIFT descriptors: CUDA kernel and plain version.

Replaces the Pallas kernel
``spectavi_tpu/ops/sift_desc.py::sift_descriptors_pallas`` together
with ``finish_descriptors`` and the uint8 step of
``features/sift.py::_describe_jobs_dev``.  For each (keypoint, angle)
row: the vlfeat 4x4x8 descriptor over the square window of radius
``radius`` centred on ``round(kp)`` and clipped to the octave (the
window of the JAX package's plain route, ``features/sift.py::
descriptors``).  Offsets are rotated by ``theta0`` and scaled by
``SBP = magnif sigma``; the Gaussian window has sigma ``2 SBP``; pixels
count inside ``|dx|, |dy| <= 2.5 sqrt(2) SBP + 0.5``; spatial bins use
bilinear weights at centres -1.5..1.5 and the 8 orientation bins are
circular with linear interpolation; layout ``desc[(by*4+bx)*8+o]``.
Then normalize, clamp at 0.2, renormalize, and ``min(floor(512 d),
255)`` as uint8.  Invalid rows give zeros.

The Pallas kernel reads an aligned 104x256 patch that caps the window
radius at 43.7 px, while the window reaches 49 px for the largest
scales, so it drops a few pixels there; this port reads the exact
window.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from spectavi_tpu_torch.ops import _build

NBP = 4
NBO = 8
WIN_FACTOR = NBP / 2.0
TWO_PI = 2.0 * np.pi

launches = 0

_ROW_CHUNK = 1024


def _const(v, like):
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def desc_raw_plain(mod, ang, kx, ky, sigma, level, theta0, valid, radius, magnif=3.0):
    """Plain PyTorch raw (unnormalized) descriptors ``(K, 128)``:
    ``mod, ang (L, H, W)`` float32 levels of one octave, per-row
    ``kx, ky, sigma, theta0`` (float32), ``level`` (int), ``valid``
    (bool)."""
    from spectavi_tpu_torch.ops.sift_orient import window_gather

    two_pi = _const(TWO_PI, mod)
    centers = torch.arange(NBP, dtype=mod.dtype, device=mod.device) - (NBP - 1) / 2.0
    obins = torch.arange(NBO, dtype=mod.dtype, device=mod.device)
    out = []
    for s in range(0, kx.shape[0], _ROW_CHUNK):
        cx, cy, cs = kx[s : s + _ROW_CHUNK], ky[s : s + _ROW_CHUNK], sigma[s : s + _ROW_CHUNK]
        cl, ct0, cv = level[s : s + _ROW_CHUNK], theta0[s : s + _ROW_CHUNK], valid[s : s + _ROW_CHUNK]
        yi = torch.round(cy).to(torch.int32)
        xi = torch.round(cx).to(torch.int32)
        m, oy, ox, inb = window_gather(mod, cl, yi, xi, radius)
        a = window_gather(ang, cl, yi, xi, radius)[0]
        SBP = magnif * cs
        wsigma = WIN_FACTOR * SBP
        Wr = SBP * (NBP + 1) / 2.0 * np.sqrt(2.0) + 0.5
        dy = (yi[:, None] + oy[None, :]).to(mod.dtype) - cy[:, None]
        dx = (xi[:, None] + ox[None, :]).to(mod.dtype) - cx[:, None]
        ct = torch.cos(ct0)[:, None]
        st = torch.sin(ct0)[:, None]
        nx = (ct * dx + st * dy) / SBP[:, None]
        ny = (-st * dx + ct * dy) / SBP[:, None]
        theta = torch.remainder(a - ct0[:, None], TWO_PI)
        nt = NBO * theta / two_pi
        win = torch.exp(-(dx * dx + dy * dy) / (2.0 * wsigma[:, None] ** 2))
        sel = inb & (torch.abs(dx) <= Wr[:, None]) & (torch.abs(dy) <= Wr[:, None])
        contrib = torch.where(sel, m * win, torch.zeros_like(m))
        wx = torch.clamp(1.0 - torch.abs(nx[:, :, None] - centers), min=0.0)
        wy = torch.clamp(1.0 - torch.abs(ny[:, :, None] - centers), min=0.0)
        dth = torch.abs(nt[:, :, None] - obins)
        dth = torch.minimum(dth, NBO - dth)
        wo = torch.clamp(1.0 - dth, min=0.0)
        cols = []
        for by in range(NBP):
            for bx in range(NBP):
                w2 = contrib * wy[:, :, by] * wx[:, :, bx]
                cols.append(torch.einsum("kp,kpo->ko", w2, wo))
        desc = torch.cat(cols, dim=1)
        out.append(torch.where(cv[:, None], desc, torch.zeros_like(desc)))
    if not out:
        return torch.zeros((0, 128), dtype=mod.dtype, device=mod.device)
    return torch.cat(out)


def cell_boxes(kx, ky, sigma, theta0, radius, H, W, magnif=3.0):
    """Pixel bounding boxes of the 16 spatial cells of each row, as the
    CUDA kernel walks them: ``(K, 16, 4)`` int32 ``(x0, x1, y0, y1)``,
    inclusive, cell ``by*4 + bx``; a box with ``x1 < x0`` or ``y1 < y0``
    is empty.

    A cell's bilinear weight ``wy wx`` is nonzero where ``|nx - cx| < 1``
    and ``|ny - cy| < 1``: a square of side ``2 SBP`` rotated by
    ``theta0`` about the rotated cell centre, so its axis-aligned box
    has half-side ``SBP (|cos| + |sin|)``.  A margin of 1e-4 of that
    plus 0.01 px stands far above the rounding of pixel coordinates.
    The box is cut to the row's window (radius ``min(radius, floor(Wr +
    0.5) + 1)`` about ``round(kp)``, outside of which every weight is
    exactly 0) and to the octave."""
    f32 = torch.float32
    kx, ky, sigma, theta0 = (t.to(f32) for t in (kx, ky, sigma, theta0))
    SBP = magnif * sigma
    Wr = ((SBP * 5.0) / 2.0) * np.float32(np.sqrt(2.0)) + 0.5
    r = torch.clamp(torch.floor(Wr + 0.5).to(torch.int32) + 1, max=int(radius))
    yi = torch.round(ky).to(torch.int32)
    xi = torch.round(kx).to(torch.int32)
    ct, st = torch.cos(theta0), torch.sin(theta0)
    ext = (SBP * (ct.abs() + st.abs())) * np.float32(1.0001) + np.float32(0.01)
    cells = torch.arange(NBP * NBP, device=kx.device)
    cy = ((cells // NBP).to(f32) - (NBP - 1) / 2.0)[None, :]
    cx = ((cells % NBP).to(f32) - (NBP - 1) / 2.0)[None, :]
    bcx = kx[:, None] + SBP[:, None] * (ct[:, None] * cx - st[:, None] * cy)
    bcy = ky[:, None] + SBP[:, None] * (st[:, None] * cx + ct[:, None] * cy)
    e = ext[:, None]

    def lo(c, centre):
        return torch.maximum(torch.clamp(centre - r, min=0)[:, None],
                             torch.floor(c - e).to(torch.int32))

    def hi(c, centre, size):
        return torch.minimum(torch.clamp(centre + r, max=size - 1)[:, None],
                             torch.ceil(c + e).to(torch.int32))

    return torch.stack([lo(bcx, xi), hi(bcx, xi, W), lo(bcy, yi), hi(bcy, yi, H)], dim=2)


def finish_descriptors(raw, valid):
    """vlfeat post-processing: normalize -> clamp 0.2 -> renormalize."""
    n = torch.linalg.vector_norm(raw, dim=1, keepdim=True)
    d = raw / torch.clamp(n, min=1e-12)
    d = torch.clamp(d, max=0.2)
    n = torch.linalg.vector_norm(d, dim=1, keepdim=True)
    d = d / torch.clamp(n, min=1e-12)
    return torch.where(valid[:, None], d, torch.zeros_like(d))


def quantize_descriptors(d):
    """vlfeat output quantization ``min(floor(512 d), 255)`` as uint8."""
    return torch.clamp(torch.floor(512.0 * d), max=255.0).to(torch.uint8)


def desc_cuda(mod, ang, kx, ky, sigma, level, theta0, valid, radius, magnif=3.0,
              return_raw=False):
    """Launch ``csrc/sift_desc.cu``: uint8 descriptors ``(K, 128)``
    (and the raw float32 rows when ``return_raw``) on CUDA tensors."""
    global launches
    if not mod.is_cuda:
        raise ValueError("desc_cuda needs CUDA tensors")
    if mod.dtype != torch.float32 or ang.dtype != torch.float32:
        raise TypeError("gradient levels must be float32")
    if mod.dim() != 3 or ang.shape != mod.shape:
        raise ValueError(f"mod/ang must share one (L, H, W) shape, got {tuple(mod.shape)}/{tuple(ang.shape)}")
    mod, ang = mod.contiguous(), ang.contiguous()
    L, H, W = mod.shape
    K = kx.shape[0]
    dev = mod.device
    f32 = [t.to(device=dev, dtype=torch.float32).contiguous() for t in (kx, ky, sigma, theta0)]
    level = level.to(device=dev, dtype=torch.int32).contiguous()
    valid = valid.to(device=dev, dtype=torch.bool).contiguous()
    out = torch.empty((K, 128), dtype=torch.uint8, device=dev)
    raw = torch.empty((K, 128), dtype=torch.float32, device=dev) if return_raw else None
    if K > 0:
        fn = _build.load("sift_desc").sift_desc
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                                  ctypes.c_void_p, ctypes.c_void_p,
                                                  ctypes.c_void_p])
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(mod.data_ptr(), ang.data_ptr(), L, H, W, f32[0].data_ptr(),
                    f32[1].data_ptr(), f32[2].data_ptr(), level.data_ptr(), f32[3].data_ptr(),
                    valid.data_ptr(), K, int(radius), float(magnif), out.data_ptr(),
                    raw.data_ptr() if return_raw else None, stream)
        _build.check(status, "sift_desc")
        launches += 1
    return (out, raw) if return_raw else out


def describe(mod, ang, kx, ky, sigma, level, theta0, valid, radius, magnif=3.0,
             return_raw=False):
    """uint8 descriptors ``(K, 128)``: the CUDA kernel for CUDA tensors,
    the plain version (+ :func:`finish_descriptors` + quantization) for
    CPU tensors.  ``return_raw`` also returns the raw float rows."""
    if mod.is_cuda:
        return desc_cuda(mod, ang, kx, ky, sigma, level, theta0, valid, radius, magnif, return_raw)
    raw = desc_raw_plain(mod, ang, kx, ky, sigma, level, theta0, valid, radius, magnif)
    out = quantize_descriptors(finish_descriptors(raw, valid))
    return (out, raw) if return_raw else out
