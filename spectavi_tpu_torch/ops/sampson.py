"""Sampson inlier counts of essential-matrix hypotheses: CUDA kernel K4
and plain version.

Replaces no Pallas kernel: the JAX package scores RANSAC hypotheses with
fused XLA einsums (``spectavi_tpu/mvg/ransac.py::_sampson_counts``).  For
hypotheses ``E (..., T, 3, 3, 3)`` (three roots a trial), their
``valid (..., T, 3)`` flags and the correspondences ``x0, x1 (..., N,
2)`` of the same leading problems, with ``point_mask (..., N)`` marking
real rows: ``counts (..., T, 3)`` int32, each valid root's count of real
rows whose Sampson distance squared is at most ``thr2``, and -1 where the
root is not valid.

For a CUDA tensor :func:`sampson_count` launches ``csrc/sampson_count.cu``
once over every problem and hypothesis; for a CPU tensor it runs the plain
version :func:`count_plain`, whose ``(..., T, 3, N, 3)`` intermediates
its caller bounds by handing it a few trials at a time
(``mvg/ransac.py::_sampson_counts``).  The kernel keeps the plain
version's float operations and their order, each rounded on its own, so
a count differs from the plain version's only where a row lies on the
threshold (the plain version's products go through a BLAS library).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from spectavi_tpu_torch.ops import _build
from spectavi_tpu_torch.utils.profiling import SAMPSON_SCORED, count

launches = 0


def count_plain(E, valid, x0, x1, point_mask, thr2):
    """Plain PyTorch Sampson counts over every hypothesis of ``E`` at
    once (see the module docstring for the arguments)."""
    x0h = torch.cat([x0, torch.ones_like(x0[..., :1])], dim=-1)
    x1h = torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1)
    Ex0 = torch.einsum("...trij,...nj->...trni", E, x0h)
    Etx1 = torch.einsum("...trji,...nj->...trni", E, x1h)
    xEx = torch.einsum("...ni,...trni->...trn", x1h, Ex0)
    denom = Ex0[..., 0] ** 2 + Ex0[..., 1] ** 2 + Etx1[..., 0] ** 2 + Etx1[..., 1] ** 2
    sampson2 = (xEx * xEx) / torch.clamp(denom, min=1e-30)
    inlier = (sampson2 <= thr2) & point_mask[..., None, None, :]
    c = inlier.sum(-1).to(torch.int32)
    return torch.where(valid, c, torch.full_like(c, -1))


_entry_point = None


def _entry():
    """The kernel's C entry point, its ``argtypes`` set once."""
    global _entry_point
    if _entry_point is None:
        fn = _build.load("sampson_count").sampson_count
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float]
                       + [ctypes.c_void_p] * 2)
        _entry_point = fn
    return _entry_point


def count_cuda(E, valid, x0, x1, point_mask, thr2):
    """Launch ``csrc/sampson_count.cu`` on contiguous CUDA tensors of one
    device: ``E`` and ``x0, x1`` float32, ``valid`` and ``point_mask``
    bool, shapes as in the module docstring.  Dtype, shape and layout
    are checked before the device; nothing falls back.  The grid is one
    thread a hypothesis, 128 a block, by problem."""
    global launches
    if E.dtype != torch.float32 or x0.dtype != torch.float32 or x1.dtype != torch.float32:
        raise TypeError(f"E, x0 and x1 must be float32, got {E.dtype}/{x0.dtype}/{x1.dtype}")
    if valid.dtype != torch.bool or point_mask.dtype != torch.bool:
        raise TypeError(f"valid and point_mask must be bool, got {valid.dtype}/{point_mask.dtype}")
    if E.dim() < 4 or tuple(E.shape[-3:]) != (3, 3, 3):
        raise ValueError(f"E must have shape (..., T, 3, 3, 3), got {tuple(E.shape)}")
    lead, T = tuple(E.shape[:-4]), E.shape[-4]
    N = x0.shape[-2] if x0.dim() >= 2 else -1
    if valid.shape != E.shape[:-2]:
        raise ValueError(f"valid must have shape {tuple(E.shape[:-2])}, got {tuple(valid.shape)}")
    for name, t, shape in (("x0", x0, lead + (N, 2)), ("x1", x1, lead + (N, 2)),
                           ("point_mask", point_mask, lead + (N,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    for name, t in (("E", E), ("valid", valid), ("x0", x0), ("x1", x1),
                    ("point_mask", point_mask)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    dev = E.device
    if not (E.is_cuda and all(t.device == dev for t in (valid, x0, x1, point_mask))):
        raise ValueError("count_cuda needs every tensor on one CUDA device")
    P, H = int(np.prod(lead, dtype=np.int64)), 3 * T
    if P > 65535 or P * H * 9 >= 2**31 or P * N * 2 >= 2**31:
        raise ValueError(f"{P} problems of {H} hypotheses over {N} rows exceed the kernel's "
                         "indexing")
    out = torch.empty(valid.shape, dtype=torch.int32, device=dev)
    if P * H == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = _entry()(E.data_ptr(), valid.data_ptr(), x0.data_ptr(), x1.data_ptr(),
                      point_mask.data_ptr(), P, H, N, float(np.float32(thr2)), out.data_ptr(),
                      stream)
    _build.check(status, "sampson_count")
    launches += 1
    count(SAMPSON_SCORED, P * H)
    return out


def sampson_count(E, valid, x0, x1, point_mask, thr2):
    """Sampson counts: the CUDA kernel for CUDA tensors (handed
    contiguous ones), the plain version for CPU tensors."""
    if E.is_cuda:
        return count_cuda(*(t.contiguous() for t in (E, valid, x0, x1, point_mask)), thr2)
    return count_plain(E, valid, x0, x1, point_mask, thr2)
