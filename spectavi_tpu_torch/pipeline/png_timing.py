"""Time the port's PNG and JPEG codecs against Pillow on the host, at the
two-view pipeline's image size.

    python -m spectavi_tpu_torch.pipeline.png_timing [--size 2048 3072] [--repeat 3]

Needs Pillow (the codec exists for machines without it; this script
measures what it costs where Pillow is installed).  The images are a
seeded multi-scale noise texture quantised to 8 bits: gray and RGB with
pixel noise (as a photograph has), and gray without it (as a smooth
rendered view is).  For each, the best of ``--repeat`` runs of:

* ``write``: the writer as shipped (:func:`io.imsave`), Pillow's
  ``Image.save`` (adaptive row filters, ``zlib`` level 6), and the
  writer's alternatives, one filter for every row at a ``zlib`` level
  (``paeth6`` is what the writer did before it took ``sub3``), each with
  the file's size in bytes;
* ``read``: the codec's and Pillow's decode of Pillow's file (a filter
  chosen a row), of a file of Paeth rows (the codec's wavefront path at
  its slowest) and of the codec's file (Sub rows, the codec's
  row-at-a-time path);
* ``step5_write``: both ``rect-*`` files of a gray pair, the codec
  against Pillow;
* ``depths``: the codec's and Pillow's decode of the gray and RGB images
  as 16-bit files and of the RGB image as an 8-bit Adam7 file, every
  row Paeth filtered, with the file's size;
* ``jpeg``: for gray and RGB with pixel noise and the smooth gray, at
  quality 75 (Pillow's default) and 95, the JPEG writer against Pillow's
  ``Image.save`` (the files must be the same bytes) and the JPEG decoder
  against Pillow's decode of that file (the arrays must be equal), with
  the file's size; and both decoders on Pillow's progressive file of the
  image (``progressive``: ``read_s``, ``bytes``).

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import struct
import tempfile
import time
import zlib

import numpy as np

from spectavi_tpu_torch.pipeline import io as pio
from spectavi_tpu_torch.pipeline.jpeg import read_jpeg, write_jpeg


def texture(rng, h, w, pixel_noise=2.0):
    """Smoothed noise at scales 8-256 px plus ``pixel_noise`` times
    uniform noise a pixel, as uint8."""
    tex = rng.random((h, w)) * pixel_noise
    for s in (8, 16, 32, 64, 128, 256):
        n = rng.random((h // s + 2, w // s + 2))
        yi, xi = np.arange(h) / s, np.arange(w) / s
        y0, x0 = yi.astype(int), xi.astype(int)
        fy, fx = (yi - y0)[:, None], (xi - x0)[None]
        tex += s ** 0.5 * (n[y0][:, x0] * (1 - fy) * (1 - fx) + n[y0 + 1][:, x0] * fy * (1 - fx)
                           + n[y0][:, x0 + 1] * (1 - fy) * fx + n[y0 + 1][:, x0 + 1] * fy * fx)
    return ((tex - tex.min()) / np.ptp(tex) * 255).astype(np.uint8)


def encode(arr, filt, level, interlace=0):
    """A PNG file's bytes, every row filtered by ``filt`` ("none",
    "sub", "up" or "paeth") and compressed at ``level``: 8-bit from
    uint8 ``arr``, 16-bit from uint16, Adam7-interlaced when
    ``interlace``."""
    h, w = arr.shape[:2]
    depth = 16 if arr.dtype == np.uint16 else 8
    channels = arr.reshape(h, w, -1).shape[2]
    parts = []
    for y0, x0, dy, dx in pio._ADAM7 if interlace else ((0, 0, 1, 1),):
        sub = arr[y0::dy, x0::dx]
        if not sub.size:
            continue
        x = sub.reshape(sub.shape[0], sub.shape[1], -1)
        if depth == 16:  # a pixel's big-endian bytes
            x = x.astype(">u2").view(np.uint8).reshape(x.shape[0], x.shape[1], -1)
        x = x.astype(np.int16)
        a = np.zeros_like(x)
        a[:, 1:] = x[:, :-1]
        b = np.zeros_like(x)
        b[1:] = x[:-1]
        c = np.zeros_like(x)
        c[1:, 1:] = x[:-1, :-1]
        pred = {"none": 0, "sub": a, "up": b, "paeth": None}[filt]
        if filt == "paeth":
            pred = pio._paeth(a, b, c)
        rows = np.empty((x.shape[0], 1 + x.shape[1] * x.shape[2]), np.uint8)
        rows[:, 0] = ("none", "sub", "up", "average", "paeth").index(filt)
        rows[:, 1:] = ((x - pred) & 255).reshape(x.shape[0], -1)
        parts.append(rows.tobytes())
    ihdr = struct.pack(">IIBBBBB", w, h, depth, pio._PNG_TYPE_OF[channels], 0, 0, interlace)
    return (pio.PNG_SIGNATURE + pio._png_chunk(b"IHDR", ihdr)
            + pio._png_chunk(b"IDAT", zlib.compress(b"".join(parts), level))
            + pio._png_chunk(b"IEND", b""))


def best(fn, repeat):
    times = []
    for _ in range(repeat):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times)


def main(argv=None):
    from PIL import Image

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, nargs=2, default=(2048, 3072))
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    rng = np.random.default_rng(args.seed)
    g0, g1 = texture(rng, *args.size), texture(rng, *args.size)
    images = {"gray": g0, "rgb": np.stack([g0, g1, g0 // 2 + g1 // 2], axis=-1),
              "smooth_gray": texture(rng, *args.size, pixel_noise=0.0)}
    out = {"host": platform.processor() or platform.machine(), "size": list(args.size),
           "repeat": args.repeat}
    with tempfile.TemporaryDirectory() as tmp:
        codec_f, pil_f, paeth_f = (os.path.join(tmp, f"{n}.png")
                                   for n in ("codec", "pillow", "paeth"))
        for name, arr in images.items():
            write = {"codec": best(lambda: pio.imsave(codec_f, arr), args.repeat),
                     "pillow": best(lambda: Image.fromarray(arr).save(pil_f), args.repeat)}
            size = {"codec": os.path.getsize(codec_f), "pillow": os.path.getsize(pil_f)}
            for filt, level in (("paeth", 6), ("paeth", 3), ("sub", 1), ("sub", 6), ("up", 3),
                                ("none", 3)):
                key = f"{filt}{level}"
                write[key] = best(lambda: encode(arr, filt, level), args.repeat)
                size[key] = len(encode(arr, filt, level))
            with open(paeth_f, "wb") as f:
                f.write(encode(arr, "paeth", 6))
            read = {}
            for src, f in (("pillow_file", pil_f), ("paeth_file", paeth_f),
                           ("codec_file", codec_f)):
                data = open(f, "rb").read()
                assert np.array_equal(pio._read_png(data), np.asarray(Image.open(f)))
                read[f"codec_{src}"] = best(lambda: pio._read_png(open(f, "rb").read()),
                                            args.repeat)
                read[f"pillow_{src}"] = best(lambda: np.asarray(Image.open(f)), args.repeat)
            out[name] = {"write_s": write, "bytes": size, "read_s": read}
        pair = (g0, g1)
        out["step5_write_s"] = {
            "codec": best(lambda: [pio.imsave(codec_f, r) for r in pair], args.repeat),
            "pillow": best(lambda: [Image.fromarray(r).save(pil_f) for r in pair], args.repeat)}
        out["depths"] = depth_times(Image, images, rng, tmp, args.repeat)
        out["jpeg"] = jpeg_times(Image, images, tmp, args.repeat)
    print(json.dumps(out))


def depth_times(Image, images, rng, tmp, repeat):
    """The codec's and Pillow's decode of the gray and RGB images as
    16-bit files of Paeth rows (a random low byte a sample) and of the
    RGB image as an 8-bit Adam7 file of Paeth rows: ``{file: {read_s,
    bytes}}``, each array checked equal to Pillow's."""
    wide = {k: (images[k].astype(np.uint16) << 8)
            | rng.integers(0, 256, images[k].shape, dtype=np.uint16) for k in ("gray", "rgb")}
    files = {"gray16_paeth": encode(wide["gray"], "paeth", 6),
             "rgb16_paeth": encode(wide["rgb"], "paeth", 6),
             "rgb_adam7_paeth": encode(images["rgb"], "paeth", 6, interlace=1)}
    out = {}
    for name, data in files.items():
        f = os.path.join(tmp, f"{name}.png")
        with open(f, "wb") as fh:
            fh.write(data)
        ref = np.asarray(Image.open(f))
        got = pio._read_png(data)
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
        out[name] = {"read_s": {"codec": best(lambda: pio._read_png(open(f, "rb").read()), repeat),
                                "pillow": best(lambda: np.asarray(Image.open(f)), repeat)},
                     "bytes": len(data)}
    return out


def jpeg_times(Image, images, tmp, repeat):
    """The JPEG codec against Pillow: ``{image: {quality: {write_s,
    read_s, bytes, progressive: {read_s, bytes}}}}``, each file and array
    checked equal to Pillow's."""
    codec_f, pil_f = os.path.join(tmp, "codec.jpg"), os.path.join(tmp, "pillow.jpg")
    prog_f = os.path.join(tmp, "progressive.jpg")
    out = {}
    for name, arr in images.items():
        out[name] = {}
        for q in (75, 95):
            write = {"codec": best(lambda: write_jpeg(codec_f, arr, quality=q), repeat),
                     "pillow": best(lambda: Image.fromarray(arr).save(pil_f, quality=q), repeat)}
            data = open(codec_f, "rb").read()
            assert data == open(pil_f, "rb").read()
            ref = np.asarray(Image.open(pil_f))
            assert np.array_equal(read_jpeg(data), ref)
            read = {"codec": best(lambda: read_jpeg(open(codec_f, "rb").read()), repeat),
                    "pillow": best(lambda: np.asarray(Image.open(pil_f)), repeat)}
            Image.fromarray(arr).save(prog_f, quality=q, progressive=True)
            prog = open(prog_f, "rb").read()
            assert np.array_equal(read_jpeg(prog), np.asarray(Image.open(prog_f)))
            progressive = {"read_s": {"codec": best(lambda: read_jpeg(open(prog_f, "rb").read()),
                                                    repeat),
                                      "pillow": best(lambda: np.asarray(Image.open(prog_f)),
                                                     repeat)},
                           "bytes": len(prog)}
            out[name][q] = {"write_s": write, "read_s": read, "bytes": len(data),
                            "progressive": progressive}
    return out


if __name__ == "__main__":
    main()
