"""The port's PNG codec on every bit depth and on Adam7, against Pillow and
the JAX package.

* Decode: every (colour type, bit depth) pair PNG allows (gray at 1, 2,
  4, 8 and 16 bits, RGB, gray + alpha and RGBA at 8 and 16, palette at
  1, 2, 4 and 8), each with every row written with one of the five
  filters and with a random filter a row, plain and Adam7-interlaced,
  gives exactly Pillow's array (``np.asarray(Image.open(f))``): dtype,
  shape and values.  The same cases hold ``chip_smoke.png_pillow_rule``
  (the table the card's run is held to) to Pillow: 1-bit gray is
  ``bool``, 2- and 4-bit gray is scaled to 0-255, 16-bit gray is
  ``uint16``, the other 16-bit types keep their high bytes and gray +
  alpha at 16 bits opens as RGBA.  The files come from
  ``test_torch_png._png`` (the PNG specification's formulas, byte by
  byte).
* Adam7 images whose passes are partly empty, sub-byte rows whose
  padding bits are set, ``tRNS`` chunks on every
  type that takes one, and palette indices at or past the PLTE's
  entries decode as Pillow decodes them.
* ``chip_smoke.py``'s phase-(a) files (its own encoder, from its seed)
  decode in Pillow to the sha256 digests that script pins, and in the
  codec to the same arrays.
* ``imread`` (``uint8``, ``float32`` gray, ``float64``) of 16-bit gray,
  16-bit RGB, 1-bit, 4-bit and Adam7 files equals the JAX package's
  ``imread``, which reads them through Pillow.
* ex01 on a 240x320 16-bit gray pair (written by Pillow): the port's run
  (``--device cpu``, the codec) against the JAX package's (Pillow) from
  the same files.
"""

import io
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from spectavi_tpu_torch.pipeline import io as pio
from test_torch_png import PALETTE, _png, _pixels

torch.set_num_threads(2)

# (colour type, bit depth) of every pair PNG allows
PAIRS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
         (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]
MODES = {(0, 1): "1", (0, 2): "L", (0, 4): "L", (0, 8): "L", (0, 16): "I;16", (2, 8): "RGB",
         (2, 16): "RGB", (4, 8): "LA", (4, 16): "RGBA", (6, 8): "RGBA", (6, 16): "RGBA"}


def _pillow(data):
    im = Image.open(io.BytesIO(data))
    return im.mode, np.asarray(im)


def _same(got, ref):
    assert got is not None
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("ctype,depth", PAIRS, ids=[f"type{c}-{d}bit" for c, d in PAIRS])
def test_depths_equal_pillow(ctype, depth, filt, interlace):
    seed = ctype * 1000 + depth * 10 + (filt if isinstance(filt, int) else 7) + 5 * interlace
    rng = np.random.default_rng(seed)
    arr = _pixels(rng, ctype, depth=depth)
    filters = rng.integers(0, 5, 200) if filt == "mixed" else [filt]
    data = _png(arr, ctype, filters, idat_parts=2, depth=depth, interlace=interlace)
    mode, ref = _pillow(data)
    assert mode == MODES.get((ctype, depth), "P")
    got = pio._read_png(data)
    _same(got, ref)
    # the rule the card's run is held to, from the samples
    _same(chip_smoke.png_pillow_rule(np, arr, ctype, depth), ref)


@pytest.mark.parametrize("shape", [(1, 1), (1, 9), (9, 1), (2, 3), (5, 5), (8, 8), (3, 17)])
def test_adam7_small_shapes(shape):
    """Images whose Adam7 passes are partly empty (no bytes, not even a
    filter type) or one pixel wide."""
    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    for ctype, depth in [(0, 1), (0, 4), (0, 16), (2, 16), (3, 2), (4, 8), (6, 16)]:
        arr = _pixels(rng, ctype, h=shape[0], w=shape[1], depth=depth)
        data = _png(arr, ctype, rng.integers(0, 5, 50), depth=depth, interlace=1)
        _same(pio._read_png(data), _pillow(data)[1])


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("ctype,depth", [(0, 1), (0, 2), (0, 4), (3, 1), (3, 2), (3, 4)])
def test_padding_bits_set(ctype, depth, interlace):
    """Rows of 37x53 samples end inside a byte (and so do most Adam7
    passes' rows): their padding bits set to ones are dropped."""
    arr = _pixels(np.random.default_rng(depth + 10 * ctype), ctype, depth=depth)
    data = _png(arr, ctype, [0, 1, 2, 3, 4], depth=depth, interlace=interlace, pad_bits=True)
    assert data != _png(arr, ctype, [0, 1, 2, 3, 4], depth=depth, interlace=interlace)
    _same(pio._read_png(data), _pillow(data)[1])


# a tRNS body for each type that takes one: gray and RGB name one
# 16-bit colour, a palette gives an alpha for each of its first entries
TRNS = {0: b"\x00\x01", 2: b"\x00\x05\x00\x06\x00\x07", 3: bytes(range(0, 200, 5))}


@pytest.mark.parametrize("ctype,depth", [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16),
                                         (3, 2), (3, 8)])
def test_trns_changes_nothing(ctype, depth):
    arr = _pixels(np.random.default_rng(depth), ctype, depth=depth)
    extra = [(b"tRNS", TRNS[ctype]), (b"gAMA", b"\x00\x00\xb1\x8f"), (b"sBIT", bytes([1] * 3))]
    data = _png(arr, ctype, [4], extra=extra[:2] if ctype == 0 else extra, depth=depth)
    mode, ref = _pillow(data)
    assert mode == MODES.get((ctype, depth), "P")
    _same(pio._read_png(data), ref)
    _same(pio._read_png(data), pio._read_png(_png(arr, ctype, [4], depth=depth)))


@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_palette_index_past_plte(depth):
    """Indices at and past a PLTE of fewer entries: Pillow keeps the
    indices as they are, and so does the codec."""
    top = 1 << depth
    arr = (np.arange(37 * 53).reshape(37, 53) % top).astype(np.uint8)
    entries = max(1, top // 2 - 1)
    for interlace in (0, 1):
        data = _png(arr, 3, [0, 4], depth=depth, interlace=interlace, palette=PALETTE[:3 * entries])
        mode, ref = _pillow(data)
        assert mode == "P" and ref.max() == top - 1 >= entries
        _same(pio._read_png(data), ref)
        np.testing.assert_array_equal(ref, arr)


def test_chip_smoke_digests_are_pillows():
    """The card's machine has no Pillow: ``chip_smoke.py`` holds the
    codec there to these digests of Pillow's arrays."""
    files = chip_smoke.png_depth_files(np)
    assert len(files) == 2 * len(chip_smoke.PNG_DEPTH_CASES) == 30
    assert set(chip_smoke.PNG_DEPTH_SHA256) == set(chip_smoke.PNG_DEPTH_CASES)
    for (name, interlace), (data, want) in files.items():
        ctype, depth = chip_smoke.PNG_DEPTH_CASES[name]
        assert data[24:29] == bytes([depth, ctype, 0, 0, interlace])
        mode, ref = _pillow(data)
        assert mode == MODES.get((ctype, depth), "P")
        assert chip_smoke.png_digest(ref) == chip_smoke.PNG_DEPTH_SHA256[name], name
        _same(want, ref)
        _same(pio._read_png(data), ref)
    # every filter type appears in the rows the files are written with
    idat = b"".join(body for name, body in pio._png_chunks(files["gray8", 0][0])
                    if name == b"IDAT")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(37, 54)
    assert set(raw[:, 0]) == {0, 1, 2, 3, 4}


def _file_kinds(tmp, rng):
    """A 16-bit gray, a 16-bit RGB, a 1-bit, a 4-bit and an Adam7 RGB
    file (``_png``, every filter type) of smooth images."""
    gray = _pixels(rng, 0, h=45, w=61)
    rgb = _pixels(rng, 2, h=45, w=61, depth=16)
    kinds = {"gray16": (chip_smoke.to_depth(np, gray / 255.0, 16, 1), 0, 16, 0),
             "rgb16": (rgb, 2, 16, 0),
             "gray1": (chip_smoke.to_depth(np, gray / 255.0, 1, 2), 0, 1, 0),
             "gray4": (chip_smoke.to_depth(np, gray / 255.0, 4, 3), 0, 4, 0),
             "adam7_rgb8": ((rgb >> 8).astype(np.uint8), 2, 8, 1)}
    paths = {}
    for name, (arr, ctype, depth, interlace) in kinds.items():
        paths[name] = str(tmp / f"{name}.png")
        with open(paths[name], "wb") as f:
            f.write(_png(arr, ctype, [0, 1, 2, 3, 4], depth=depth, interlace=interlace))
    return paths


@pytest.fixture(scope="module")
def file_kinds(tmp_path_factory):
    return _file_kinds(tmp_path_factory.mktemp("kinds"), np.random.default_rng(11))


@pytest.mark.parametrize("form", ["uint8", "float32-gray", "float64"])
@pytest.mark.parametrize("kind", ["gray16", "rgb16", "gray1", "gray4", "adam7_rgb8"])
def test_imread_vs_jax(file_kinds, kind, form):
    from spectavi_tpu.pipeline import io as jio

    dtype = form.split("-")[0]
    gray = form.endswith("gray")
    got = pio.imread(file_kinds[kind], dtype=dtype, force_grayscale=gray)
    ref = jio.imread(file_kinds[kind], dtype=dtype, force_grayscale=gray)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    if dtype != "uint8":
        assert got.max() == 1.0


def test_ex01_gray16_vs_jax(tmp_path, monkeypatch):
    """ex01 from a 240x320 16-bit gray pair: the port (``--device cpu``,
    its codec) against the JAX package (Pillow) on the same files.  A
    cold run of each: the same keypoint and match counts within 1%, as
    ``tests/test_torch_entry_points.py`` holds the 8-bit pair; then the
    port given JAX's ``cache.npz`` and RANSAC draws: identical matches,
    inliers and PLY colours (step 4's integer branch on ``uint16``), the
    cloud within ``tests/test_mvg.py``'s tolerances, and ``rect-*``
    (step 5 on max-normalised floats) JAX's pixels except in ROADMAP C's
    column-0 rows."""
    from spectavi_tpu.pipeline import ex01 as jax_ex01
    from spectavi_tpu_torch.pipeline import ex01
    from test_sfm_pipeline import _tiny_dataset
    from test_torch_entry_points import EX01_ARGS, _ex01_on_jax_cache_vs_jax, _metrics

    paths8, kfile, _ = _tiny_dataset(tmp_path, np.random.default_rng(0xDEADBEEF), nviews=2,
                                     H=240, W=320)
    paths = []
    for i, p in enumerate(paths8):
        g16 = chip_smoke.to_depth(np, np.asarray(Image.open(p)) / 255.0, 16, 30 + i)
        paths.append(str(tmp_path / f"g{i}.png"))
        Image.fromarray(g16).save(paths[-1])
        assert Image.open(paths[-1]).mode == "I;16"
        got = pio.imread(paths[-1], dtype="uint8")
        assert got.dtype == np.uint16
        np.testing.assert_array_equal(got, g16)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jax_ex01.main([*paths, kfile, "--outdir", str(jdir), *EX01_ARGS])
    ex01.main([*paths, kfile, "--outdir", str(pdir), "--device", "cpu", *EX01_ARGS])
    mt, mj = _metrics(pdir), _metrics(jdir)
    assert mj["n_matches"] >= 100
    for a, b in zip(mt["keypoints"], mj["keypoints"]):
        assert abs(a - b) <= 0.01 * b
    assert abs(mt["n_matches"] - mj["n_matches"]) <= 0.01 * mj["n_matches"]
    cache = tmp_path / "port_on_jax"
    rect = _ex01_on_jax_cache_vs_jax(paths, kfile, jdir, cache, monkeypatch)
    mc = _metrics(cache)
    assert mc["n_matches"] == mj["n_matches"] and mc["n_inliers"] == mj["n_inliers"]
    jm, cm = np.load(jdir / "cache.npz"), np.load(cache / "cache.npz")
    for k in ("xd", "yd"):
        np.testing.assert_array_equal(jm[k], cm[k])
    # the rectified pixels that differ (all in column 0 of the second image)
    moved = [int((a != b).any(axis=-1).sum() if a.ndim == 3 else (a != b).sum())
             for a, b in zip(*rect)]
    assert moved[0] == 0 and moved[1] <= 240
    print("rect pixels differing from JAX's:", moved, "of", rect[0][1].size)
