"""JPEG through the port's own codec (``csrc/jpeg_host.cpp``).

The codec is host C++, compiled with the host compiler at first use
(:mod:`spectavi_tpu_torch.ops._build`) and called through ``ctypes``:

* :func:`read_jpeg` decodes Huffman JPEG at 8 bits, sequential (SOF0 and
  SOF1) or progressive (SOF2), gray or YCbCr/RGB at any integral
  sampling factors (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1, ...), to exactly
  the array ``np.asarray(PIL.Image.open(f))`` gives with Pillow's
  libjpeg-turbo (integer inverse DCT, its upsampling methods, fixed-point
  colour conversion, and its block smoothing of a progressive file
  whose scans leave any of the first nine AC coefficients unrefined).
  It returns None for the JPEG variants it leaves to Pillow (arithmetic
  coding, lossless, hierarchical, 12-bit, 2 or 4 components such as
  CMYK and YCCK, non-integral sampling factors), each known before any
  scan is decoded, and raises ``ValueError`` for a malformed file.
* :func:`write_jpeg` writes the file that Pillow's ``Image.fromarray(arr)
  .save(path)`` writes for a ``.jpg`` name: baseline, quality 75, 4:2:0
  for RGB, one component for gray.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

_ERR_LEN = 256
_u8p = ctypes.POINTER(ctypes.c_uint8)


@functools.lru_cache(maxsize=None)
def _lib():
    from spectavi_tpu_torch.ops import _build

    lib = _build.load("jpeg_host")
    err = (ctypes.c_char_p, ctypes.c_int64)
    lib.jpeg_probe.argtypes = (ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
                               *err)
    lib.jpeg_decode.argtypes = (ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                                *err)
    lib.jpeg_encode.argtypes = (ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                                ctypes.c_int32, ctypes.POINTER(_u8p),
                                ctypes.POINTER(ctypes.c_int64), *err)
    lib.jpeg_free.argtypes = (_u8p,)
    for fn in (lib.jpeg_probe, lib.jpeg_decode, lib.jpeg_encode):
        fn.restype = ctypes.c_int
    lib.jpeg_free.restype = None
    return lib


def read_jpeg(data):
    """The pixels of a JPEG file's bytes ``data`` as Pillow's array,
    ``(H, W)`` or ``(H, W, 3)`` uint8, or None for a variant the codec
    leaves to Pillow."""
    lib = _lib()
    data = bytes(data)
    dims = (ctypes.c_int32 * 3)()
    err = ctypes.create_string_buffer(_ERR_LEN)
    status = lib.jpeg_probe(data, len(data), dims, err, _ERR_LEN)
    if status == 0:
        h, w, c = dims
        out = np.empty((h, w) if c == 1 else (h, w, c), np.uint8)
        status = lib.jpeg_decode(data, len(data), out.ctypes.data, out.size, err, _ERR_LEN)
    if status < 0:
        raise ValueError(err.value.decode(errors="replace"))
    return out if status == 0 else None


def write_jpeg(path, arr, quality=75):
    """Write ``arr``, uint8 ``(H, W)`` or ``(H, W, 3)``, as the baseline
    JPEG that Pillow writes at ``quality`` (its default is 75)."""
    arr = np.ascontiguousarray(arr)
    channels = 1 if arr.ndim == 2 else arr.shape[-1] if arr.ndim == 3 else 0
    if arr.dtype != np.uint8 or channels not in (1, 3):
        raise ValueError(f"JPEG writer takes uint8 (H, W) or (H, W, 3), got {arr.dtype} "
                         f"{arr.shape}")
    lib = _lib()
    buf, size = _u8p(), ctypes.c_int64()
    err = ctypes.create_string_buffer(_ERR_LEN)
    status = lib.jpeg_encode(arr.ctypes.data, arr.shape[0], arr.shape[1], channels, int(quality),
                             ctypes.byref(buf), ctypes.byref(size), err, _ERR_LEN)
    if status != 0:
        raise ValueError(err.value.decode(errors="replace"))
    try:
        data = ctypes.string_at(buf, size.value)
    finally:
        lib.jpeg_free(buf)
    with open(path, "wb") as f:
        f.write(data)
