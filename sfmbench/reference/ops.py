"""Plain PyTorch operations of the reference.

Frozen copies of the port's plain versions (``spectavi_tpu_torch``:
``mvg/core.py``, ``ops/sift_orient.py``, ``ops/sift_desc.py``,
``ops/l2nn.py``, ``features/normalize.py``), run on every device,
the card included: no CUDA kernel of the port is reached from here.
The port's CUDA kernels (K1 ``l2nn_top2``, K2 ``sift_orient``, K3
``sift_desc``) are held to these plain versions by their own tests;
the benchmark holds the whole front end to them.
"""

from __future__ import annotations

import numpy as np
import torch

NBINS = 36
NBP = 4
NBO = 8
WIN_FACTOR = NBP / 2.0
TWO_PI = 2.0 * np.pi
MAX_ANGLES = 4

_ROW_CHUNK = 4096
_DESC_ROW_CHUNK = 1024
_QUERY_CHUNK = 4096

def hnormalize(x):
    """Homogeneous -> euclidean along the last axis."""
    return x[..., :-1] / x[..., -1:]


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


def _det3(M):
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


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


def orientation_peaks(hist, kp_valid):
    """vlfeat orientation post-processing on raw 36-bin histograms: 6x
    circular box smoothing, peaks >= 0.8 max with parabolic refinement,
    up to 4 angles in ascending bin order.  ``hist (K, 36)`` ->
    ``(angles (K, 4), avalid (K, 4))``; ``kp_valid`` None means every
    row."""
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
    return th, (avalid if kp_valid is None else avalid & kp_valid[:, None])


def desc_raw_plain(mod, ang, kx, ky, sigma, level, theta0, valid, radius, magnif=3.0):
    """Plain PyTorch raw (unnormalized) descriptors ``(K, 128)``:
    ``mod, ang (L, H, W)`` float32 levels of one octave, per-row
    ``kx, ky, sigma, theta0`` (float32), ``level`` (int), ``valid``
    (bool)."""
    two_pi = _const(TWO_PI, mod)
    centers = torch.arange(NBP, dtype=mod.dtype, device=mod.device) - (NBP - 1) / 2.0
    obins = torch.arange(NBO, dtype=mod.dtype, device=mod.device)
    out = []
    for s in range(0, kx.shape[0], _DESC_ROW_CHUNK):
        c = slice(s, s + _DESC_ROW_CHUNK)
        cx, cy, cs = kx[c], ky[c], sigma[c]
        cl, ct0, cv = level[c], theta0[c], valid[c]
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


def _to_i8(a):
    if a.dtype == torch.uint8:
        return (a.to(torch.int32) - 128).to(torch.int8)
    if a.dtype == torch.int8:
        return a
    raise TypeError(
        "expected uint8/int8 descriptors (values outside int8 range would "
        f"wrap); got {a.dtype}. Pre-quantize with normalize_to_ubyte_device."
    )


def l2_topk_mxu(x, y, k=2):
    """Plain exact top-k squared-L2 neighbours of ``y (Y, D)`` rows among
    ``x (X, D)`` rows (uint8 or int8, same dtype).  Queries are taken
    in chunks of 4096 so the ``(Y, X)`` distance block stays bounded."""
    if x.dtype != y.dtype:
        raise TypeError(f"descriptor dtypes must match, got {x.dtype}/{y.dtype}")
    xi, yi = _to_i8(x), _to_i8(y)
    ft = torch.float32 if x.is_cuda else torch.float64
    xf, yf = xi.to(ft), yi.to(ft)
    xx = (xf * xf).sum(1)
    idxs, dists = [], []
    for s in range(0, yf.shape[0], _QUERY_CHUNK):
        yc = yf[s : s + _QUERY_CHUNK]
        yy = (yc * yc).sum(1)
        d2 = yy[:, None] - 2.0 * (yc @ xf.T) + xx[None, :]
        ii, dd = [], []
        for _ in range(k):
            i = torch.argmin(d2, dim=1)
            ii.append(i)
            dd.append(d2.gather(1, i[:, None])[:, 0])
            d2.scatter_(1, i[:, None], float("inf"))
        idxs.append(torch.stack(ii, 1))
        dists.append(torch.stack(dd, 1))
    idx = torch.cat(idxs).to(torch.int32)
    dist = torch.cat(dists).to(torch.int32)
    return idx, dist


def normalize_to_ubyte_device(x):
    """Tensor twin of :func:`normalize_to_ubyte_and_multiple_16_dim`
    with the matcher's ``+128`` offset fused in: ``(n, d)`` float
    tensor in, ``(n, 16-padded d)`` uint8 tensor on the same device out
    (padding columns hold 128).  The column mean accumulates in float64,
    as the host quantizer's does."""
    xf = x.to(torch.float32)
    mean = xf.to(torch.float64).mean(0).to(torch.float32)
    centered = xf - mean
    span = torch.clamp(
        torch.maximum(centered.amax(0), -centered.amin(0)),
        min=float(np.finfo(np.float32).tiny),
    )
    quant = torch.clamp(torch.round(centered * (128.0 / span)), -128, 127)
    pad = (-quant.shape[1]) % 16
    out = torch.nn.functional.pad(quant + 128.0, (0, pad), value=128.0)
    return out.to(torch.uint8)


def orient_hist(mod, ang, kx, ky, sigma, level, valid, radius):
    """Orientation histograms by the plain version; ``valid`` None
    means every row."""
    if valid is None:
        valid = torch.ones(kx.shape[0], dtype=torch.bool, device=mod.device)
    return orient_hist_plain(mod, ang, kx, ky, sigma, level, valid, radius)


def describe(mod, ang, kx, ky, sigma, level, theta0, valid, radius, magnif=3.0,
             return_raw=False):
    """uint8 descriptors ``(K, 128)`` by the plain version, finished and
    quantized; ``return_raw`` also returns the raw float rows."""
    raw = desc_raw_plain(mod, ang, kx, ky, sigma, level, theta0, valid, radius, magnif)
    out = quantize_descriptors(finish_descriptors(raw, valid))
    return (out, raw) if return_raw else out
