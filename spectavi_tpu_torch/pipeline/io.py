"""Image / matrix / point-cloud IO and timing helpers.

The port's own copy of ``spectavi_tpu/pipeline/io.py`` (pure numpy;
Pillow is imported only when an image is decoded): imread with max
normalization, BT.601 grayscale, ``Timer``, metrics JSON, ASCII PLY.
"""

from __future__ import annotations

import functools as _functools
import os
import time

import numpy as np


class Timer:
    """Wall-clock context manager printing per-step timings."""

    def __init__(self, description, quiet=False):
        self.description = description
        self.quiet = quiet
        self.elapsed = None

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        if not self.quiet:
            print(f"{self.description}: {self.elapsed}s")


def write_metrics(path, metrics):
    """Write a machine-readable per-run metrics record (every pipeline
    run drops a ``metrics.json`` next to its outputs)."""
    import json

    with open(path, "w") as f:
        json.dump(metrics, f, indent=2, sort_keys=True, default=float)


def rgb_to_gray(rgb, dtype=np.float64):
    """BT.601 luma weights, like the reference's ``rgb_to_gray``."""
    if rgb.ndim < 3:
        return np.squeeze(rgb).astype(dtype)
    return rgb[..., :3].astype(dtype) @ np.asarray(
        [0.2989, 0.5870, 0.1140], dtype
    )


@_functools.lru_cache(maxsize=8)
def _decode(filename, mtime):
    """Decoded raw pixel array, cached: the pipeline reads each image
    for SIFT (grayscale), rectification (color) and PLY colors."""
    from PIL import Image

    im = np.asarray(Image.open(filename))
    im.flags.writeable = False
    return im


def imread(filename, dtype="float64", force_grayscale=False):
    """Read an image, max-normalized for float dtypes (reference
    ``example/util.py:41-64``)."""
    im = _decode(filename, os.path.getmtime(filename))
    if dtype == "uint8":
        # raw decoded pixels (read-only cache view), which the
        # rectification uploads 4x cheaper than the normalized floats
        return im
    if force_grayscale:
        # luma math in the output precision (f64 matches the reference
        # bit-for-bit; the pipeline reads float32)
        im = rgb_to_gray(im, np.float32 if dtype == "float32" else np.float64)
    im = im.astype(dtype)
    if dtype in ("float32", "float64"):
        # single max-normalization (as the reference does); guard the
        # all-black case so it yields zeros instead of NaNs
        im = im / np.maximum(np.max(im), np.finfo(im.dtype).tiny)
    return im


def read_txt_matrix(txtf, header=False):
    rows = []
    with open(txtf) as f:
        for iline, line in enumerate(f):
            if iline == 0 and header:
                continue
            line = line.strip()
            if line:
                rows.append([float(v) for v in line.split()])
    return np.asarray(rows)


def write_ply(plyfile, data, rgb=None):
    """ASCII PLY point-cloud writer (reference ``ex01`` ``write_ply``)."""
    with open(plyfile, "w") as f:
        f.write("ply\n")
        f.write("format ascii 1.0\n")
        f.write("element vertex %d\n" % data.shape[0])
        f.write("property float x\n")
        f.write("property float y\n")
        f.write("property float z\n")
        if rgb is not None:
            f.write("property uchar red\n")
            f.write("property uchar green\n")
            f.write("property uchar blue\n")
        f.write("end_header\n")
        if rgb is None:
            for p in data:
                f.write("%f %f %f\n" % (p[0], p[1], p[2]))
        else:
            for p, c in zip(data, rgb):
                f.write(
                    "%f %f %f %d %d %d\n" % (p[0], p[1], p[2], c[0], c[1], c[2])
                )


def read_ply(plyfile):
    """Minimal ASCII PLY reader (for tests / ATE harnesses)."""
    with open(plyfile) as f:
        assert f.readline().strip() == "ply"
        n = 0
        for line in f:
            line = line.strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            if line == "end_header":
                break
        pts = []
        for _ in range(n):
            pts.append([float(v) for v in f.readline().split()[:3]])
    return np.asarray(pts)
