"""ctypes bindings for the native host-ops library.

The port's own copy of the JAX package's loader
(``spectavi_tpu/utils/hostops.py``): it loads
``native/libspectavi_hostops.so`` (building it with ``make`` on first
use if the library is absent).  The library is plain C++ with OpenMP:
a re-implementation of the reference's SSE L1-K2 matcher
(``src/BruteForceNnL1K2.h``), its scalar loop, and a SIFT, which serve
as the measured CPU baseline and as host-side fallbacks.  Numpy in,
numpy out.
"""

from __future__ import annotations

import ctypes as ct
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libspectavi_hostops.so")

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True, capture_output=True)
    lib = ct.CDLL(_LIB_PATH)
    lib.hostops_l1k2_nn.restype = None
    lib.hostops_l1k2_nn.argtypes = [
        np.ctypeslib.ndpointer(ct.c_uint8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(ct.c_uint8, flags="C_CONTIGUOUS"),
        ct.c_int,
        ct.c_int,
        ct.c_int,
        ct.c_int,
        np.ctypeslib.ndpointer(ct.c_int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(ct.c_int32, flags="C_CONTIGUOUS"),
    ]
    lib.hostops_sift.restype = ct.c_int
    lib.hostops_sift.argtypes = [
        np.ctypeslib.ndpointer(ct.c_float, flags="C_CONTIGUOUS"),
        ct.c_int,
        ct.c_int,
        ct.c_int,
        ct.c_double,
        ct.c_double,
        ct.c_double,
        ct.c_int,
        np.ctypeslib.ndpointer(ct.c_float, flags="C_CONTIGUOUS"),
        ct.c_int,
    ]
    lib.hostops_l1k2_nn_scalar.restype = None
    lib.hostops_l1k2_nn_scalar.argtypes = [
        np.ctypeslib.ndpointer(ct.c_float, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(ct.c_float, flags="C_CONTIGUOUS"),
        ct.c_int,
        ct.c_int,
        ct.c_int,
        ct.c_int,
        np.ctypeslib.ndpointer(ct.c_int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(ct.c_float, flags="C_CONTIGUOUS"),
    ]
    _lib = lib
    return lib


def l1k2_nn_cpu(x, y, nthreads=None):
    """Exact top-2 L1 NN on uint8 descriptors via the native SSE kernel."""
    lib = _load()
    x = np.ascontiguousarray(x, dtype=np.uint8)
    y = np.ascontiguousarray(y, dtype=np.uint8)
    assert x.shape[1] == y.shape[1] and x.shape[1] % 16 == 0
    if nthreads is None:
        nthreads = os.cpu_count() or 1
    idx = np.empty((y.shape[0], 2), dtype=np.int64)
    dist = np.empty((y.shape[0], 2), dtype=np.int32)
    lib.hostops_l1k2_nn(
        x, y, x.shape[0], y.shape[0], x.shape[1], int(nthreads), idx, dist
    )
    return idx, dist


def sift_cpu(im, nthreads=None, peak_thresh=0.0, edge_thresh=10.0,
             magnif=3.0, o_min=-1):
    """Native C++/OpenMP SIFT (native/sift_baseline.cpp): the CPU
    throughput baseline for the device SIFT path, and a host-side
    fallback detector.  Returns ``(nkp, 132)`` float32 rows
    ``[x, y, sigma, angle, desc x 128]`` (same layout as
    ``features.sift_filter``)."""
    lib = _load()
    im = np.ascontiguousarray(im, dtype=np.float32)
    assert im.ndim == 2
    if nthreads is None:
        nthreads = os.cpu_count() or 1
    cap = 1 << 14
    while True:
        out = np.empty((cap, 132), dtype=np.float32)
        n = lib.hostops_sift(
            im, im.shape[1], im.shape[0], int(nthreads),
            float(peak_thresh), float(edge_thresh), float(magnif),
            int(o_min), out, cap,
        )
        if n >= 0:
            return out[:n].copy()
        cap = -n


def l1k2_nn_cpu_scalar(x, y, nthreads=None):
    """Generic scalar-loop L1 top-2 (the reference's non-SSE comparison point)."""
    lib = _load()
    x = np.ascontiguousarray(x, dtype=np.float32)
    y = np.ascontiguousarray(y, dtype=np.float32)
    assert x.shape[1] == y.shape[1]
    if nthreads is None:
        nthreads = os.cpu_count() or 1
    idx = np.empty((y.shape[0], 2), dtype=np.int64)
    dist = np.empty((y.shape[0], 2), dtype=np.float32)
    lib.hostops_l1k2_nn_scalar(
        x, y, x.shape[0], y.shape[0], x.shape[1], int(nthreads), idx, dist
    )
    return idx, dist
