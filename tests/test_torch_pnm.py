"""The port's Netpbm reader and writer (``spectavi_tpu_torch.pipeline.io``)
against Pillow, and the pipelines from Netpbm files against the JAX
package.

* Decode: every magic (``P1``-``P6``: PBM, PGM and PPM, plain and raw)
  at maxvals from 1 to 65535 and sizes from 1x1 to 37x53 gives exactly
  ``np.asarray(Image.open(f))``: dtype, shape and values (PBM ``bool``
  with black ``False``; PGM ``uint8`` up to maxval 255, ``int32`` scaled
  to 0-65535 above; PPM ``uint8`` scaled to 0-255), raw samples above
  maxval too.  The files come from this file's own encoder (``_pnm``).
* Headers and plain bodies with comments and whitespace anywhere, as
  Pillow's ``PpmImagePlugin`` reads them (a comment inside a number
  joins its two halves).
* Malformed files raise ``ValueError`` (and Pillow raises too): a short
  raster or plain body, maxval 0 or above 65535, a magic not followed by
  whitespace, a plain sample above maxval or negative, a bad bitmap
  byte, a zero width, a header cut short, a number of over ten bytes.
* ``chip_smoke.py``'s 24 small files (its own encoder, from its seed)
  decode in Pillow to the digests that script pins, and in the reader
  to the same arrays.
* ``imread`` (``uint8``, ``float32`` gray, ``float64``) of 8-bit and
  16-bit PGM, PPM and PBM equals the JAX package's ``imread``.
* ``imsave`` writes Pillow's bytes for 8-bit gray and RGB, and hands
  any other array to Pillow; with Pillow blocked every kind is read, and
  8-bit RGB written.
* ex01 from a 240x320 PPM pair and ``run_sfm`` from 3 views as 16-bit
  PGM, given JAX's matches and RANSAC draws, against the JAX package's,
  as ``tests/test_torch_jpeg_progressive.py`` holds progressive JPEG.
"""

import io
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from sfmbench import scene
from spectavi_tpu_torch.pipeline import io as pio
from test_torch_jpeg import ex01_on_jax_matches_and_draws_vs_jax, run_sfm_vs_jax

torch.set_num_threads(2)

MAXVALS = [1, 2, 15, 100, 255, 256, 1000, 4095, 65534, 65535]
CASES = [(1, 1), (4, 1)] + [(m, v) for m in (2, 3, 5, 6) for v in MAXVALS]
SIZES = [(1, 1), (2, 3), (9, 8), (37, 53)]


def _pnm(values, magic, maxval, head=None, sep=b" ", line=7):
    """A Netpbm file of ``values`` as the file holds them: the header
    ``head`` (magic, width, height and maxval with newlines between,
    when None), plain numbers joined by ``sep`` with a newline after
    every ``line`` of them (bits without separators), raw samples big
    endian above maxval 255, bits packed most significant first."""
    h, w = values.shape[:2]
    if head is None:
        head = b"P%d\n%d %d\n" % (magic, w, h) + (b"" if magic in (1, 4) else b"%d\n" % maxval)
    flat = [int(v) for v in values.ravel()]
    if magic == 1:
        body = b"".join(b"%d" % v + (b"\n" if i % line == line - 1 else b"")
                        for i, v in enumerate(flat))
    elif magic in (2, 3):
        body = b"".join(b"%d" % v + (b"\n" if i % line == line - 1 else sep)
                        for i, v in enumerate(flat))
    elif magic == 4:
        body = np.packbits(values.astype(np.uint8), axis=1).tobytes()
    else:
        body = values.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    return head + body


def _values(rng, magic, maxval, h, w):
    shape = (h, w, 3) if magic in (3, 6) else (h, w)
    return rng.integers(0, maxval + 1, shape)


def _pillow(data):
    return np.asarray(Image.open(io.BytesIO(data)))


def _same(got, ref):
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("magic,maxval", CASES, ids=[f"P{m}-{v}" for m, v in CASES])
def test_decode_equals_pillow(magic, maxval):
    rng = np.random.default_rng(magic * 100000 + maxval)
    for h, w in SIZES:
        data = _pnm(_values(rng, magic, maxval, h, w), magic, maxval)
        ref = _pillow(data)
        _same(pio._read_pnm(data), ref)
        want = {1: np.bool_, 4: np.bool_}.get(magic, np.int32 if magic in (2, 5) and maxval > 255
                                              else np.uint8)
        assert ref.dtype == want and ref.shape[:2] == (h, w)


@pytest.mark.parametrize("magic", [5, 6])
@pytest.mark.parametrize("maxval", [1, 100, 1000, 65534])
def test_raw_samples_above_maxval(magic, maxval):
    """A raw sample above maxval scales past the top: Pillow caps it."""
    rng = np.random.default_rng(maxval + magic)
    top = 255 if maxval < 256 else 65535
    values = rng.integers(0, top + 1, (9, 11, 3) if magic == 6 else (9, 11))
    values[0] = rng.integers(maxval + 1, top + 1, values[0].shape)
    data = _pnm(values, magic, maxval)
    _same(pio._read_pnm(data), _pillow(data))


# header layouts: (name, header of a 3x2 image, plain separator)
HEADERS = {
    "spaces": (b"P%d 3 2 %s", b" "),
    "comments-everywhere": (b"P%d\n# a\n#b\r3\n# c\n2\n#d\n%s", b" "),
    "crlf-tabs-vt-ff": (b"P%d\r\n3\t\x0b2\x0c\r\n%s", b"\t"),
    "comment-inside-number": (b"P%d 1#x\n2 2 %s", b"\n"),
    "runs-of-space": (b"P%d   \n\n3  \t 2 \r\r %s", b"  \r "),
}


@pytest.mark.parametrize("magic", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("layout", sorted(HEADERS))
def test_header_layouts(layout, magic):
    head, sep = HEADERS[layout]
    maxval = 200
    h, w = 2, 12 if layout == "comment-inside-number" else 3
    if magic in (1, 4):
        head = head.replace(b" %s", b"\n").replace(b"%s", b"")
    else:
        head = head.replace(b"%s", b"%d\n" % maxval)
    data = _pnm(_values(np.random.default_rng(magic), magic, 1 if magic in (1, 4) else maxval, h,
                        w), magic, maxval, head=head % magic, sep=sep, line=5)
    ref = _pillow(data)
    assert ref.shape[:2] == (h, w)
    _same(pio._read_pnm(data), ref)


def test_plain_body_comments():
    """A ``#`` in a plain body drops the rest of its line with its CR or
    LF, joining what is around it."""
    for magic, body, want in ((2, b"1 2#c\n3 4 #x\r5 6", [1, 23, 4, 5, 6, 0]),
                              (1, b"1#c\n0 1 # \n0 1\n#z\n0", None)):
        data = (b"P%d 3 2\n" % magic + (b"99\n" if magic == 2 else b"") + body
                + (b" 0" if magic == 2 else b""))
        ref = _pillow(data)
        _same(pio._read_pnm(data), ref)
        if want:
            np.testing.assert_array_equal(ref.ravel(), np.round(np.array(want) / 99 * 255))


@pytest.mark.parametrize("body", [b"1 +2 3 1_0", b"+0 00 007 1_00", b"0 1\t2\x0b3"],
                         ids=["sign-underscore", "leading-zeros", "vt"])
def test_plain_numbers_as_python_reads_them(body):
    """Pillow reads each plain number with Python's ``int``: a sign and
    underscores are taken, and so is any whitespace Python splits on."""
    data = b"P2 2 2 100\n" + body
    _same(pio._read_pnm(data), _pillow(data))


def test_raster_starts_after_one_whitespace_byte():
    """The raster starts right after the byte that ends maxval, even a
    byte that would otherwise be whitespace or a comment."""
    for tail in (b"\n", b" ", b"\r\n"):
        data = b"P5 4 1 255" + tail + b"\x0a#\x20\x41"
        ref = _pillow(data)
        _same(pio._read_pnm(data), ref)
        np.testing.assert_array_equal(ref[0], np.frombuffer(data[11:15], np.uint8))


MALFORMED = {
    "short-p5": b"P5 4 4 255\n" + bytes(10),
    "short-p5-16bit": b"P5 4 4 65535\n" + bytes(31),
    "short-p5-maxval-100": b"P5 4 4 100\n" + bytes(15),
    "short-p6": b"P6 2 2 255\n" + bytes(11),
    "short-p4": b"P4 9 4\n" + bytes(7),
    "short-p2": b"P2 2 2 255\n1 2 3",
    "short-p3": b"P3 1 1 255\n1 2",
    "short-p1": b"P1 2 2\n1 0 1",
    "maxval-0": b"P5 2 2 0\n" + bytes(4),
    "maxval-65536": b"P5 2 2 65536\n" + bytes(8),
    "magic-not-ended": b"P5x 2 2 255\n" + bytes(4),
    "plain-above-maxval": b"P2 2 2 10\n1 2 3 11",
    "plain-negative": b"P2 2 2 10\n1 2 3 -1",
    "plain-not-a-number": b"P3 1 1 255\n1 2 x3",
    "bitmap-byte": b"P1 2 2\n1 0 1 2",
    "width-0": b"P5 0 2 255\n",
    "height-negative": b"P6 2 -1 255\n",
    "header-ends": b"P5 2 2",
    "magic-only": b"P6",
    "long-header-number": b"P5 00000000002 2 255\n" + bytes(4),
    "long-plain-number": b"P2 2 2 255\n1 2 3 00000000001",
    "header-not-a-number": b"P5 2 2 2x5\n" + bytes(4),
}


@pytest.mark.parametrize("how", sorted(MALFORMED))
def test_malformed_raises(tmp_path, how):
    data = MALFORMED[how]
    with pytest.raises(Exception):
        _pillow(data)
    with pytest.raises(ValueError):
        pio._read_pnm(data)
    # imread raises too: a Netpbm magic never goes on to Pillow
    path = tmp_path / "bad.pnm"
    path.write_bytes(data)
    with pytest.raises(ValueError):
        pio.imread(str(path))


def test_chip_smoke_pnm_digests_are_pillows():
    """The card's machine has no Pillow: ``chip_smoke.py`` holds the
    reader there to these digests of Pillow's arrays."""
    files = chip_smoke.pnm_digest_files(np)
    assert len(files) == len(chip_smoke.PNM_SHA256) == 24
    magics = {chip_smoke.PNM_CASES[n][0] for n in files}
    maxvals = {chip_smoke.PNM_CASES[n][1] for n in files}
    assert magics == {1, 2, 3, 4, 5, 6} and maxvals >= {1, 15, 100, 255, 256, 1000, 65535}
    for name, data in files.items():
        assert b"#" in data.split(b"\n", 2)[1]
        ref = _pillow(data)
        assert chip_smoke.png_digest(ref) == chip_smoke.PNM_SHA256[name], name
        _same(pio._read_pnm(data), ref)


def _file_kinds(tmp, rng):
    """A P5 at maxval 255 and at 65535, a P6 and a P4 of a smooth image,
    and a plain P2 at maxval 1000."""
    from test_torch_png import _pixels

    gray = _pixels(rng, 0, h=45, w=61)
    rgb = _pixels(rng, 2, h=45, w=61)
    kinds = {"p5_8bit": (gray, 5, 255),
             "p5_16bit": (chip_smoke.to_depth(np, gray / 255.0, 16, 1), 5, 65535),
             "p6": (rgb, 6, 255),
             "p4": (gray < 128, 4, 1),
             "p2_1000": (np.round(gray / 255.0 * 1000).astype(int), 2, 1000)}
    paths = {}
    for name, (arr, magic, maxval) in kinds.items():
        paths[name] = str(tmp / f"{name}.pnm")
        with open(paths[name], "wb") as f:
            f.write(_pnm(arr, magic, maxval))
    return paths


@pytest.fixture(scope="module")
def file_kinds(tmp_path_factory):
    return _file_kinds(tmp_path_factory.mktemp("kinds"), np.random.default_rng(12))


@pytest.mark.parametrize("form", ["uint8", "float32-gray", "float64"])
@pytest.mark.parametrize("kind", ["p5_8bit", "p5_16bit", "p6", "p4", "p2_1000"])
def test_imread_vs_jax(file_kinds, kind, form):
    from spectavi_tpu.pipeline import io as jio

    dtype = form.split("-")[0]
    gray = form.endswith("gray")
    got = pio.imread(file_kinds[kind], dtype=dtype, force_grayscale=gray)
    ref = jio.imread(file_kinds[kind], dtype=dtype, force_grayscale=gray)
    _same(got, np.asarray(ref))
    if dtype != "uint8":
        assert got.max() == 1.0


@pytest.mark.parametrize("ext", [".pbm", ".pgm", ".ppm", ".pnm"])
@pytest.mark.parametrize("kind", ["uint8", "rgb"])
def test_writer_equals_pillow(tmp_path, kind, ext):
    """Pillow writes Netpbm by the array's mode, whatever the extension."""
    rng = np.random.default_rng(len(kind))
    arr = rng.integers(0, 256, (5, 13, 3) if kind == "rgb" else (5, 13), dtype=np.uint8)
    got, want = tmp_path / f"port{ext}", tmp_path / f"pillow{ext}"
    pio.imsave(str(got), arr)
    Image.fromarray(arr).save(want)
    assert got.read_bytes() == want.read_bytes()
    _same(pio.imread(str(got), dtype="uint8"), np.asarray(Image.open(want)))


def test_writer_refuses_other_arrays(tmp_path, monkeypatch):
    """The writer takes 8-bit gray and RGB only: any other array goes to
    Pillow, which is blocked here."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    for bad in (np.zeros((4, 4), bool), np.zeros((4, 4), np.uint16), np.zeros((4, 4, 4), np.uint8),
                np.zeros((4, 4, 2), np.uint8), np.zeros((4, 4), np.float32),
                np.zeros((4, 4, 3), np.uint16), np.zeros(4, np.uint8)):
        with pytest.raises(ImportError):
            pio.imsave(str(tmp_path / "x.ppm"), bad)


def test_without_pillow(file_kinds, tmp_path, monkeypatch):
    """With Pillow blocked every kind is read, and a PPM written."""
    refs = {k: np.asarray(Image.open(p)) for k, p in file_kinds.items()}
    monkeypatch.setitem(sys.modules, "PIL", None)
    pio._decode.cache_clear()
    with pytest.raises(ImportError):
        pio._pillow()
    for kind, path in file_kinds.items():
        _same(pio.imread(path, dtype="uint8"), refs[kind])
    pio.imsave(str(tmp_path / "w.ppm"), refs["p6"])
    _same(pio.imread(str(tmp_path / "w.ppm"), dtype="uint8"), refs["p6"])


# --- the pipelines from Netpbm files against the JAX package ---------------


@pytest.fixture(scope="module")
def ppm_pair(tmp_path_factory):
    """The rendered 240x320 pair of ``test_sfm_pipeline._tiny_dataset`` as
    8-bit PPM (``chip_smoke.pnm_encode``, RGB with distinct channels)."""
    from test_sfm_pipeline import _tiny_dataset

    tmp = tmp_path_factory.mktemp("ppm_pair")
    pngs, kfile, _ = _tiny_dataset(tmp, np.random.default_rng(0xDEADBEEF), nviews=2, H=240,
                                   W=320)
    paths = []
    for i, p in enumerate(pngs):
        paths.append(str(tmp / f"c{i}.ppm"))
        rgb = scene.as_rgb(np.asarray(Image.open(p)))
        with open(paths[-1], "wb") as f:
            f.write(chip_smoke.pnm_encode(np, rgb, 6, 255))
    return tmp, paths, kfile, None


def test_ex01_ppm_pair_vs_jax(ppm_pair, monkeypatch):
    ex01_on_jax_matches_and_draws_vs_jax(ppm_pair, monkeypatch)


@pytest.fixture(scope="module")
def pgm16_views(tmp_path_factory):
    """The 3 rendered 120x160 views as 16-bit PGM (maxval 65535, one at
    4095; a seeded dither in the low bits): ``int32`` decodes."""
    from test_sfm_pipeline import _tiny_dataset

    tmp = tmp_path_factory.mktemp("pgm16_views")
    pngs, kfile, gt_C = _tiny_dataset(tmp, np.random.default_rng(0xDEADBEEF))
    paths = []
    for i, p in enumerate(pngs):
        depth = 12 if i == 1 else 16
        g = chip_smoke.to_depth(np, np.asarray(Image.open(p)) / 255.0, depth, 50 + i)
        paths.append(str(tmp / f"v{i}.pgm"))
        with open(paths[-1], "wb") as f:
            f.write(chip_smoke.pnm_encode(np, g, 5, (1 << depth) - 1))
        assert Image.open(paths[-1]).mode == "I"
    return tmp, paths, kfile, gt_C


def test_run_sfm_pgm16_vs_jax(pgm16_views, monkeypatch):
    assert pio.imread(pgm16_views[1][0], dtype="uint8").dtype == np.int32
    run_sfm_vs_jax(pgm16_views, monkeypatch)
