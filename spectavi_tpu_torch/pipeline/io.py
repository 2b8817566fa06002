"""Image / matrix / point-cloud IO and timing helpers.

The port's own copy of ``spectavi_tpu/pipeline/io.py``: imread with max
normalization, BT.601 grayscale, ``Timer``, metrics JSON, ASCII PLY.

PNG, JPEG and Netpbm go through codecs of the port's own, so the
pipelines run from such files on machines without Pillow:

* PNG (numpy and the standard library's ``zlib``): :func:`imread` reads
  every PNG the standard allows (gray at 1, 2, 4, 8 and 16 bits, RGB,
  gray + alpha and RGBA at 8 and 16, palette at 1, 2, 4 and 8, each
  plain or Adam7-interlaced) to exactly the array
  ``np.asarray(PIL.Image.open(f))`` gives: 1-bit gray as ``bool``, 2-
  and 4-bit gray scaled to 0-255, 16-bit gray as ``uint16``, the other
  16-bit types as their high bytes (gray + alpha as RGBA), palette
  images as their indices.  :func:`imsave` writes 8-bit gray,
  gray + alpha, RGB and RGBA PNG.
* JPEG (host C++, :mod:`spectavi_tpu_torch.pipeline.jpeg`, compiled at
  first use): :func:`imread` reads baseline and progressive Huffman
  JPEG at 8 bits, gray or colour at any integral sampling factors (a
  progressive file's unrefined coefficients smoothed as libjpeg-turbo
  smooths them), to exactly Pillow's array, and :func:`imsave` writes
  the ``.jpg`` / ``.jpeg`` file that Pillow writes (baseline, quality
  75, 4:2:0 for RGB).
* Netpbm (numpy): :func:`imread` reads PBM, PGM and PPM (``P1``-``P6``,
  plain and raw, maxval 1-65535) to Pillow's array: PBM as ``bool``,
  PGM as ``uint8`` up to maxval 255 and as ``int32`` above it, PPM as
  ``uint8`` RGB, scaled as Pillow scales them.  :func:`imsave` writes
  8-bit PGM and PPM as Pillow writes them.

Other formats go through Pillow: TIFF, BMP, WebP and the rest, and the
JPEG variants the codec does not read (arithmetic-coded, lossless,
hierarchical or 12-bit JPEG, CMYK and YCCK, non-integral sampling
factors).
"""

from __future__ import annotations

import functools as _functools
import os
import struct
import time
import zlib

import numpy as np
from numpy.lib.stride_tricks import as_strided

from spectavi_tpu_torch.pipeline.jpeg import read_jpeg, write_jpeg


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


PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# channels and allowed bit depths of each colour type
_PNG_FORMATS = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
                4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7's seven passes: first row, first column, row step, column step
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
          (1, 0, 2, 1))
# colour type the writer gives each channel count
_PNG_TYPE_OF = {1: 0, 2: 4, 3: 2, 4: 6}


def _png_chunks(data):
    """``(type, body)`` of each chunk after the signature, up to IEND,
    each chunk's length and CRC checked."""
    pos = len(PNG_SIGNATURE)
    while True:
        if pos + 8 > len(data):
            raise ValueError("PNG ends before its IEND chunk")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 12 + length
        if end > len(data):
            raise ValueError(f"PNG chunk {ctype!r} runs past the end of the file")
        body = data[pos + 8:end - 4]
        if zlib.crc32(ctype + body) != struct.unpack(">I", data[end - 4:end])[0]:
            raise ValueError(f"PNG chunk {ctype!r} fails its CRC")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos = end


def _png_header(data):
    """IHDR's ``(width, height, bit_depth, colour_type, interlace)``."""
    if len(data) < 33:
        raise ValueError("PNG ends inside its IHDR chunk")
    length, ctype = struct.unpack(">I4s", data[8:16])
    if ctype != b"IHDR" or length != 13:
        raise ValueError("PNG does not start with a 13-byte IHDR chunk")
    w, h, depth, ctype_, comp, filt, interlace = struct.unpack(">IIBBBBB", data[16:29])
    if w == 0 or h == 0 or comp != 0 or filt != 0 or interlace > 1:
        raise ValueError(f"PNG IHDR is invalid: {w}x{h}, compression {comp}, filter "
                         f"method {filt}, interlace {interlace}")
    return w, h, depth, ctype_, interlace


def _paeth(a, b, c):
    """The Paeth predictor of int16 arrays: ``a`` left, ``b`` above,
    ``c`` above left."""
    da, db = a - c, b - c
    pa, pb, pc = np.abs(db), np.abs(da), np.abs(da + db)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _png_unfilter(raw, bpp):
    """Undo the PNG row filters of ``raw``, ``(H, 1 + W * bpp)`` uint8
    (each row's filter type, then its bytes): ``(H, W, bpp)`` uint8.

    Sub, Average and Paeth read the byte ``bpp`` to the left in the same
    row, and Up, Average and Paeth the row above, once reconstructed.
    So the pixels run in anti-diagonal wavefronts: pixel ``(r, x)``
    needs only pixels of the two diagonals ``r + x - 1`` and
    ``r + x - 2``, and each of the ``H + W - 1`` steps is a few numpy
    operations over the whole diagonal, every row with its own filter.
    The image is held skewed, diagonal ``k`` contiguous, in a zero
    border: diagonals -2 and -1 and the row above row 0."""
    H = raw.shape[0]
    W = (raw.shape[1] - 1) // bpp
    ftype = raw[:, 0]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"PNG row filter type {int(ftype.max())} is not one of 0-4")
    if ftype.max(initial=0) <= 2:
        # None, Sub and Up only (what the writer writes): no row reads
        # both neighbours, so a row at a time, Sub as a running sum
        out = raw[:, 1:].reshape(H, W, bpp).copy()
        for r in np.flatnonzero(ftype):
            if ftype[r] == 1:
                out[r] = np.cumsum(out[r], axis=0, dtype=np.uint8)
            elif r:
                out[r] += out[r - 1]
        return out
    K = H + W - 1
    # filt[k, r] = the filtered bytes of pixel (r, k - r)
    filt = np.zeros((K, H, bpp), np.uint8)
    as_strided(filt, shape=(H, W, bpp), strides=((H + 1) * bpp, H * bpp, 1))[:] = (
        raw[:, 1:].reshape(H, W, bpp))
    # rec[k + 2, r + 1] = pixel (r, k - r) reconstructed, as int16
    rec = np.zeros((K + 2, H + 1, bpp), np.int16)
    # rows of each filter type up to row r, and each type's row mask
    runs = [np.concatenate([[0], np.cumsum(ftype == f)]) for f in range(5)]
    is_type = [(ftype == f)[:, None] for f in range(5)]
    for k in range(K):
        lo, hi = max(0, k - W + 1), min(H, k + 1)
        a = rec[k + 1, lo + 1:hi + 1]  # left
        b = rec[k + 1, lo:hi]  # above
        c = rec[k, lo:hi]  # above left
        out = rec[k + 2, lo + 1:hi + 1]
        types = [f for f in (1, 2, 3, 4) if runs[f][hi] != runs[f][lo]]
        if not types:
            out[:] = filt[k, lo:hi]
            continue
        pred = 0
        for f in types:
            p = a if f == 1 else b if f == 2 else (a + b) >> 1 if f == 3 else _paeth(a, b, c)
            uniform = runs[f][hi] - runs[f][lo] == hi - lo
            pred = p if uniform else np.where(is_type[f][lo:hi], p, pred)
        np.add(filt[k, lo:hi], pred, out=out)
        out &= 255
    # pixel (r, x) sits at rec[r + x + 2, r + 1]
    isz = rec.itemsize
    return as_strided(rec[2, 1:], shape=(H, W, bpp),
                      strides=((H + 2) * bpp * isz, (H + 1) * bpp * isz, isz)).astype(np.uint8)


def _png_samples(rows, width, depth, channels):
    """Unfiltered rows ``(H, bytes)`` uint8 as samples ``(H, width,
    channels)``: below 8 bits unpacked most significant bits first, the
    row's padding bits dropped; 16 bits big-endian to native uint16."""
    h = rows.shape[0]
    if depth == 8:
        return rows.reshape(h, width, channels)
    if depth == 16:
        return rows.view(">u2").reshape(h, width, channels).astype(np.uint16)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    samples = (rows[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
    return samples.reshape(h, -1)[:, :width, None]


def _as_pillow(samples, depth, ctype):
    """Samples ``(H, W, C)`` as Pillow gives the image: palette indices
    as they are, gray at 1 bit as ``bool`` and at 2 and 4 bits scaled to
    0-255, gray at 16 bits as ``uint16``, the other 16-bit types as
    their high bytes, gray + alpha at 16 bits as RGBA."""
    if ctype in (0, 3):
        samples = samples[..., 0]
        if ctype == 0 and depth == 1:
            return samples != 0
        if ctype == 0 and depth < 8:
            return samples * np.uint8(255 // ((1 << depth) - 1))
        return samples
    if depth == 16:
        samples = (samples >> 8).astype(np.uint8)
        if ctype == 4:
            return samples[..., [0, 0, 0, 1]]
    return samples


def _read_png(data):
    """The pixels of a PNG file as Pillow's array (every bit depth and
    colour type, plain or Adam7-interlaced); ``ValueError`` for a file
    that is not valid PNG."""
    w, h, depth, ctype, interlace = _png_header(data)
    if ctype not in _PNG_FORMATS or depth not in _PNG_FORMATS[ctype][1]:
        raise ValueError(f"PNG colour type {ctype} at {depth} bits is not a valid pair")
    idat, seen, plte = [], [], False
    for name, body in _png_chunks(data):
        if name == b"IDAT":
            if idat and seen[-1] != b"IDAT":
                raise ValueError("PNG IDAT chunks are not consecutive")
            idat.append(body)
        elif name == b"PLTE":
            plte = True
        seen.append(name)
    if not idat:
        raise ValueError("PNG has no IDAT chunk")
    if ctype == 3 and not plte:
        raise ValueError("palette PNG has no PLTE chunk")
    channels = _PNG_FORMATS[ctype][0]
    bits = depth * channels
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"PNG image data does not inflate: {e}") from e
    # each pass with pixels: (first row, first column, row step, column
    # step, rows, pixels a row, bytes a row with its filter type)
    passes = []
    for y0, x0, dy, dx in _ADAM7 if interlace else ((0, 0, 1, 1),):
        ph, pw = -(-(h - y0) // dy), -(-(w - x0) // dx)
        if ph > 0 and pw > 0:
            passes.append((y0, x0, dy, dx, ph, pw, 1 + (pw * bits + 7) // 8))
    need = sum(p[4] * p[6] for p in passes)
    if raw.size != need:
        raise ValueError(f"PNG image data holds {raw.size} bytes, {need} expected for {w}x{h} "
                         f"at {depth} bits, colour type {ctype}, interlace {interlace}")
    # the filters read the byte a pixel to the left (one byte below 8
    # bits); each pass is an image of its own, its first row filtered
    # against zeros, scattered into the frame
    bpp = max(1, bits // 8)
    samples, pos = None, 0
    for y0, x0, dy, dx, ph, pw, row in passes:
        rows = _png_unfilter(raw[pos:pos + ph * row].reshape(ph, row), bpp).reshape(ph, -1)
        pos += ph * row
        sub = _png_samples(rows, pw, depth, channels)
        if not interlace:
            samples = sub
        else:
            if samples is None:
                samples = np.empty((h, w, channels), sub.dtype)
            samples[y0::dy, x0::dx] = sub
    return _as_pillow(samples, depth, ctype)


# Netpbm: the whitespace of a header and of a plain body, and each
# magic's Pillow mode before its maxval is read
_PNM_SPACE = b" \t\n\x0b\x0c\r"
_PNM_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB"}
# the longest number Pillow takes in a header or a plain body
_PNM_TOKEN = 10


def _pnm_header(data, count):
    """The first ``count`` header tokens after the magic and where the
    raster starts, as Pillow's ``PpmImageFile._read_token`` reads them: a
    token ends at one whitespace byte (consumed) or the end of the data,
    and a ``#`` anywhere drops the rest of its line, its CR or LF too,
    without ending the token."""
    pos, tokens = 3, []
    for _ in range(count):
        token = bytearray()
        while len(token) <= _PNM_TOKEN and pos < len(data):
            c = data[pos]
            pos += 1
            if c in _PNM_SPACE:
                if token:
                    break
            elif c == 0x23:
                while pos < len(data):
                    pos += 1
                    if data[pos - 1] in b"\r\n":
                        break
            else:
                token.append(c)
        if not token or len(token) > _PNM_TOKEN:
            raise ValueError(f"Netpbm header ends early or has a token of over {_PNM_TOKEN} "
                             f"bytes: {bytes(token)[:_PNM_TOKEN + 1]!r}")
        tokens.append(int(token))
    return tokens, pos


def _pnm_uncommented(body):
    """A plain body without its ``#`` comments, each dropped with its
    CR or LF, as Pillow's ``PpmPlainDecoder`` drops them."""
    import re

    return re.sub(rb"#[^\r\n]*[\r\n]?", b"", body)


def _pnm_plain(body, count, maxval):
    """The first ``count`` numbers of a plain body (comments dropped), as
    Pillow's ``PpmPlainDecoder`` reads them: Python's ``int`` of each
    whitespace-separated token of at most ten bytes (a sign and
    underscores taken), each from 0 to ``maxval``; int64."""
    tokens = body.split()[:count]
    if len(tokens) < count:
        raise ValueError(f"Netpbm plain body holds {len(tokens)} samples, {count} expected")
    if any(len(t) > _PNM_TOKEN for t in tokens):
        raise ValueError(f"Netpbm plain body has a sample of over {_PNM_TOKEN} bytes")
    values = np.array([int(t) for t in tokens], np.int64)
    if values.size and (values.min() < 0 or values.max() > maxval):
        raise ValueError(f"Netpbm plain body has a sample outside 0-{maxval}")
    return values


def _read_pnm(data):
    """The pixels of a Netpbm file (``P1``-``P6``: PBM, PGM and PPM, plain
    and raw) as Pillow's array: PBM as ``bool`` with black (1) ``False``;
    PGM at maxval 255 as ``uint8``, at other maxvals up to 255 scaled to
    0-255, above 255 as ``int32`` scaled to 0-65535; PPM as ``uint8`` RGB
    scaled to 0-255.  Scaling rounds ``v / maxval * top`` half to even, as
    Pillow's ``round`` does, and caps a raw sample above maxval at the top.
    ``ValueError`` for a file that is not valid Netpbm."""
    magic = bytes(data[:2])
    if magic not in _PNM_MODES or (len(data) > 2 and data[2] not in _PNM_SPACE):
        raise ValueError(f"not a Netpbm file: magic {bytes(data[:3])!r}")
    mode = _PNM_MODES[magic]
    (w, h, *maxval), pos = _pnm_header(data, 2 if mode == "1" else 3)
    if w <= 0 or h <= 0:
        raise ValueError(f"Netpbm image is {w}x{h}")
    body = data[pos:]
    if mode == "1":
        if magic == b"P4":
            row = -(-w // 8)
            if len(body) < h * row:
                raise ValueError(f"Netpbm raster holds {len(body)} bytes, {h * row} expected")
            bits = np.unpackbits(np.frombuffer(body, np.uint8, h * row).reshape(h, row), axis=1)
            return bits[:, :w] == 0
        b = np.frombuffer(_pnm_uncommented(body), np.uint8)
        b = b[~np.isin(b, np.frombuffer(_PNM_SPACE, np.uint8))]
        if not np.isin(b, (48, 49)).all():
            raise ValueError("Netpbm plain bitmap has a byte other than 0, 1 and whitespace")
        if b.size < w * h:
            raise ValueError(f"Netpbm plain bitmap holds {b.size} samples, {w * h} expected")
        return (b[:w * h] == 48).reshape(h, w)
    maxval = maxval[0]
    if not 0 < maxval < 65536:
        raise ValueError(f"Netpbm maxval {maxval} is not 1-65535")
    bands = 3 if mode == "RGB" else 1
    wide = mode == "L" and maxval > 255  # Pillow's mode I
    top, dtype = (65535, np.int32) if wide else (255, np.uint8)
    count = w * h * bands
    shape = (h, w, 3) if bands == 3 else (h, w)
    if magic in (b"P2", b"P3"):
        values = _pnm_plain(_pnm_uncommented(body), count, maxval)
    else:
        size = 1 if maxval < 256 else 2
        if len(body) < count * size:
            raise ValueError(f"Netpbm raster holds {len(body)} bytes, {count * size} expected")
        values = np.frombuffer(body, ">u2" if size == 2 else np.uint8, count)
        if maxval == top:
            return values.astype(dtype).reshape(shape)
    scaled = np.rint(values / maxval * top)
    return np.minimum(scaled, top).astype(dtype).reshape(shape)


def _pillow():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "this image format needs Pillow, which is not installed; PNG, Netpbm "
            "(PBM, PGM, PPM) and 8-bit Huffman JPEG are read without it (and JPEG "
            "and 8-bit PNG written); TIFF, BMP, WebP and arithmetic-coded, "
            "lossless, 12-bit or CMYK JPEG are not") from e
    return Image


@_functools.lru_cache(maxsize=8)
def _decode(filename, mtime):
    """Decoded raw pixel array, cached: the pipeline reads each image
    for SIFT (grayscale), rectification (color) and PLY colors.  PNG and
    Netpbm never go to Pillow (a malformed file raises ``ValueError``),
    nor does JPEG that the codec reads."""
    with open(filename, "rb") as f:
        data = f.read()
    if data[:8] == PNG_SIGNATURE:
        im = _read_png(data)
    elif data[:2] in _PNM_MODES:
        im = _read_pnm(data)
    else:
        im = read_jpeg(data) if data[:2] == b"\xff\xd8" else None
        if im is None:
            im = np.asarray(_pillow().open(filename))
    im.flags.writeable = False
    return im


def _png_chunk(ctype, body):
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(
        ">I", zlib.crc32(ctype + body))


def _write_png(filename, arr):
    """8-bit PNG of ``(H, W)`` or ``(H, W, C)`` uint8, ``C`` 1 to 4 (gray,
    gray + alpha, RGB, RGBA), every row Sub filtered and compressed at
    ``zlib`` level 3: in a fifth to a half of the time that Paeth rows
    at level 6 take, within 3% of their size on the noisy and smooth
    textures of ``pipeline/png_timing.py`` and 14% above it on the
    rendered RGB pair of ``chip_smoke.py``."""
    arr = np.asarray(arr)
    channels = 1 if arr.ndim == 2 else arr.shape[-1] if arr.ndim == 3 else 0
    if arr.dtype != np.uint8 or channels not in _PNG_TYPE_OF:
        raise ValueError(f"PNG writer takes uint8 (H, W) or (H, W, 1-4), got {arr.dtype} "
                         f"{arr.shape}")
    h, w = arr.shape[:2]
    x = arr.reshape(h, w * channels)
    rows = np.empty((h, 1 + w * channels), np.uint8)
    rows[:, 0] = 1
    rows[:, 1:1 + channels] = x[:, :channels]
    np.subtract(x[:, channels:], x[:, :-channels], out=rows[:, 1 + channels:])
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _PNG_TYPE_OF[channels], 0, 0, 0)
    with open(filename, "wb") as f:
        f.write(PNG_SIGNATURE + _png_chunk(b"IHDR", ihdr)
                + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 3))
                + _png_chunk(b"IEND", b""))


def _write_pnm(filename, arr):
    """The raw PGM (``uint8`` ``(H, W)``) or PPM (``uint8`` ``(H, W, 3)``)
    that Pillow's ``Image.fromarray(arr).save`` writes for a ``.pbm``,
    ``.pgm``, ``.ppm`` or ``.pnm`` name, whichever it is: maxval 255."""
    head = b"P5" if arr.ndim == 2 else b"P6"
    with open(filename, "wb") as f:
        f.write(head + b"\n%d %d\n255\n" % (arr.shape[1], arr.shape[0])
                + np.ascontiguousarray(arr).tobytes())


def imsave(filename, arr):
    """Write an image: ``.png`` through the PNG codec (8-bit gray, gray +
    alpha, RGB or RGBA), ``.jpg`` / ``.jpeg`` through the JPEG codec
    (gray or RGB, as Pillow writes it), ``.pbm`` / ``.pgm`` / ``.ppm`` /
    ``.pnm`` of 8-bit gray or RGB as Pillow writes Netpbm, any other
    format or array through Pillow."""
    name = filename.lower()
    arr = np.asarray(arr)
    if name.endswith(".png"):
        _write_png(filename, arr)
    elif name.endswith((".jpg", ".jpeg")):
        write_jpeg(filename, arr)
    elif (name.endswith((".pbm", ".pgm", ".ppm", ".pnm")) and arr.dtype == np.uint8
          and (arr.ndim == 2 or arr.ndim == 3 and arr.shape[2] == 3)):
        _write_pnm(filename, arr)
    else:
        _pillow().fromarray(arr).save(filename)


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
