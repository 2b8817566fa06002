"""Exact top-2 squared-L2 matching on byte descriptors.

Port of ``spectavi_tpu/ops/l2nn.py`` and of the Pallas kernel
``spectavi_tpu/ops/l2nn_pallas.py::l2_topk2_pallas``.  For a CUDA
tensor :func:`l2_topk2` launches the hand-written kernel
``csrc/l2nn_top2.cu``; for a CPU tensor it runs the plain version
:func:`l2_topk_mxu`.  Both return ``(idx (Y, 2) int32, dist2 (Y, 2)
int32)`` ascending, with ties to the lower database index.

The plain version shifts uint8 input by -128 into int8, which leaves
distances unchanged (the kernel's tensor-core route works on the raw
bytes, for the same reason).  It forms ``||y||^2 - 2 y.x + ||x||^2``
with a float matmul, exact because every product and partial sum is an
integer far below 2^24 (float32, TF32 off) or 2^53 (float64), and
takes the top-k as argmin followed by masked argmins, so ties go to the
lower index as ``lax.top_k`` gives them.
"""

from __future__ import annotations

import ctypes

import torch

from spectavi_tpu_torch.ops import _build

launches = 0

_QUERY_CHUNK = 4096


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


# the tensor-core kernel keeps a query tile and a ring of database tiles
# of D padded to 32 bytes in shared memory: up to this many bytes a row
_TC_MAX_D = 256


def l2_topk2_cuda(x, y):
    """Launch ``csrc/l2nn_top2.cu`` on CUDA byte tensors ``x (X, D)``,
    ``y (Y, D)`` of one dtype (uint8 or int8), any D with
    ``D * 255**2 < 2**31``.

    The kernel has two routes, chosen by the shape alone: D (padded
    with zero columns to a multiple of 16, one small copy when it is
    not one already) up to 256 runs on the int8 tensor cores; a larger
    D runs on the CUDA cores (``__dp4a``).  A build or launch failure
    raises; there is no other fallback."""
    global launches
    if not (x.is_cuda and y.is_cuda and x.device == y.device):
        raise ValueError("l2_topk2_cuda needs both tensors on one CUDA device")
    if x.dtype != y.dtype or x.dtype not in (torch.uint8, torch.int8):
        raise TypeError(f"uint8/int8 descriptors of one dtype required, got {x.dtype}/{y.dtype}")
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"shapes must be (X, D) and (Y, D), got {tuple(x.shape)}/{tuple(y.shape)}")
    if x.shape[0] < 2:
        raise ValueError("top-2 needs at least 2 database rows")
    if x.shape[1] * 255**2 >= 2**31:
        raise ValueError(f"D = {x.shape[1]} overflows the int32 distance")
    X, D = x.shape
    Y = y.shape[0]
    idx = torch.empty((Y, 2), dtype=torch.int32, device=y.device)
    dist = torch.empty((Y, 2), dtype=torch.int32, device=y.device)
    if Y == 0:
        return idx, dist
    tensor_cores = D + (-D) % 16 <= _TC_MAX_D
    if tensor_cores and D % 16:
        # a zero column adds 0 to every product and norm of the raw bytes
        x, y = (torch.nn.functional.pad(t, (0, (-D) % 16)) for t in (x, y))
        D = x.shape[1]
    x, y = x.contiguous(), y.contiguous()
    lib = _build.load("l2nn_top2")
    if tensor_cores:
        # the kernel reads rows as 16-byte words
        x, y = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, y))
        lib.l2nn_top2_scratch_bytes.restype = ctypes.c_longlong
        lib.l2nn_top2_scratch_bytes.argtypes = [ctypes.c_int] * 3
        n_scratch = lib.l2nn_top2_scratch_bytes(X, Y, D)
    else:
        n_scratch = 4 * (X + Y)
    scratch = torch.empty(n_scratch, dtype=torch.uint8, device=x.device)
    fn = lib.l2nn_top2
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    stream = torch.cuda.current_stream(y.device).cuda_stream
    status = fn(x.data_ptr(), y.data_ptr(), X, Y, D, int(x.dtype == torch.uint8),
                int(tensor_cores), scratch.data_ptr(), idx.data_ptr(), dist.data_ptr(),
                stream)
    _build.check(status, "l2nn_top2")
    launches += 1
    return idx, dist


def l2_topk2(x, y):
    """Top-2 exact squared-L2 matcher: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if x.is_cuda or y.is_cuda:
        return l2_topk2_cuda(x, y)
    return l2_topk_mxu(x, y, k=2)
