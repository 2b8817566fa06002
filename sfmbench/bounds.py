"""The yardstick of the kernels: published peaks and each kernel's
least time.

Frozen copies of ``chip_smoke.py``'s ``PEAK_*`` constants and
``k1_bound_ms`` / ``window_pixels`` / ``k2_bound_ms`` / ``k3_bound_ms``.
A launch's bound is the larger of its operations over the peak rate of
their type and its bytes over the memory bandwidth, counted from the
launch's own shapes and rows (``launch_bound_ms``): K1 ``2 X Y D`` int8
operations; K2 and K3 the in-window pixels of each row.
"""

from __future__ import annotations

import math

import numpy as np

# published H100 SXM peaks (dense): int8 tensor ops, float32 CUDA-core
# flops, device-memory bytes per second
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# the device functions of each kernel's C entry point, as the profiler
# names them, keyed by the Python wrapper that launches them
KERNELS = {
    "K1": ("spectavi_tpu_torch.ops.l2nn", "l2_topk2_cuda",
           ("make_tiles", "row_norms", "top2_wgmma_kernel", "top2_dp4a_kernel")),
    "K2": ("spectavi_tpu_torch.ops.sift_orient", "orient_hist_cuda", ("orient_kernel",)),
    "K3": ("spectavi_tpu_torch.ops.sift_desc", "desc_cuda", ("desc_kernel",)),
}


def k1_bound_ms(X, Y, D):
    ops = 2.0 * X * Y * D
    nbytes = (X + Y) * D + Y * 16
    return max(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES) * 1e3, (
        "operations" if ops / PEAK_INT8_OPS >= nbytes / PEAK_BYTES else "bytes")


def window_pixels(H_, W_, xs, ys, radii):
    """In-octave pixel count of square windows of the given radii."""
    yi, xi = np.round(ys).astype(np.int64), np.round(xs).astype(np.int64)
    ny = np.minimum(yi + radii, H_ - 1) - np.maximum(yi - radii, 0) + 1
    nx = np.minimum(xi + radii, W_ - 1) - np.maximum(xi - radii, 0) + 1
    return np.clip(ny, 0, None) * np.clip(nx, 0, None)


def k2_bound_ms(L, H_, W_, kx, ky, sigma):
    """Bytes: each row's pixels inside r^2 < Wr^2 + 0.6 (two float32
    levels), capped at the levels' size, plus row metadata and the
    histogram out.  Operations: ~16 float32 flops per counted pixel
    (offsets, r^2, exp, weight, bin)."""
    Wr = np.maximum(np.floor(3.0 * 1.5 * sigma), 1.0)
    px = np.pi * (Wr * Wr + 0.6)
    nbytes = min(px.sum() * 8, L * H_ * W_ * 8) + len(kx) * (5 * 4 + 36 * 4)
    flops = 16.0 * px.sum()
    t_b, t_o = nbytes / PEAK_BYTES, flops / PEAK_F32_FLOPS
    return float(max(t_b, t_o) * 1e3), ("operations" if t_o >= t_b else "bytes")


def k3_bound_ms(L, H_, W_, kx, ky, sigma, R, magnif=3.0):
    """Bytes: each row's pixels inside its box (two float32 levels),
    capped at the levels' size, plus metadata and the uint8 row out.
    Operations: per box pixel ~25 float32 flops of geometry and window
    plus ~4 per each of the 8 bins its trilinear weight reaches."""
    Wr = magnif * sigma * 2.5 * math.sqrt(2.0) + 0.5
    r = np.minimum(np.floor(Wr + 0.5).astype(np.int64), R)
    px = window_pixels(H_, W_, kx, ky, r).astype(np.float64)
    nbytes = min(px.sum() * 8, L * H_ * W_ * 8) + len(kx) * (6 * 4 + 128)
    flops = (25.0 + 8 * 4.0) * px.sum()
    t_b, t_o = nbytes / PEAK_BYTES, flops / PEAK_F32_FLOPS
    return float(max(t_b, t_o) * 1e3), ("operations" if t_o >= t_b else "bytes")


def launch_bound_ms(kernel, args):
    """Least milliseconds of one launch of ``kernel`` ("K1", "K2", "K3")
    from the arguments its wrapper was called with."""
    if kernel == "K1":
        x, y = args[0], args[1]
        return k1_bound_ms(x.shape[0], y.shape[0], x.shape[1])[0]
    mod = args[0]
    L, H_, W_ = mod.shape
    kx, ky, sigma = (np.asarray(t.detach().cpu(), np.float64) for t in args[2:5])
    if kernel == "K2":
        return k2_bound_ms(L, H_, W_, kx, ky, sigma)[0]
    radius = args[8]
    magnif = args[9] if len(args) > 9 else 3.0
    return k3_bound_ms(L, H_, W_, kx, ky, sigma, radius, magnif)[0]
