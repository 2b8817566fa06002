"""The port's JPEG decoder (``csrc/jpeg_host.cpp``) on progressive files
whose scans leave coefficients unrefined, which libjpeg-turbo smooths
before its inverse DCT (``jdcoefct.c``: ``smoothing_ok`` and
``decompress_smooth_data``), against Pillow, and ex01 from such files
against the JAX package.

* Pillow's progressive files cut after every scan (``cut_after_scan``):
  gray and RGB at 4:4:4, 4:2:2 and 4:2:0, quality 50, 75 and 95, sizes
  1x1 to 61x83 and 599x800, with and without restart markers; every
  element equal, with dtype and shape, to ``np.asarray(Image.open(f))``.
* Files of this file's own scan scripts (``test_torch_jpeg_progressive``'s
  entropy coder, ``coded_jpeg``), at any sampling factors: zigzag 1-9
  complete and 10-63 left at Al 1 (no smoothing: the bands past 9 play
  no part), 1-8 complete and 9-63 at Al 1 (smoothing), DC scans only
  (the "change DC" estimate), luma AC only (chroma changes DC, luma is
  left), and a quantization table with a zero where smoothing reads it
  (no smoothing) or past it (smoothing).
* A bounded ``hypothesis`` search over cut point, size, sampling,
  quality, content and restarts.
* ``chip_smoke.py``'s ``JPEG_SMOOTH_SHA256`` (the committed progressive
  fixtures cut after every scan, which the card's machine, without
  Pillow, decodes) against Pillow's arrays.
* With Pillow blocked the cut files are read all the same.
* ex01 from a 240x320 pair of progressive RGB JPEG cut after its fifth
  scan: the decodes are the JAX package's (Pillow's), and given JAX's
  matches and RANSAC draws the port's ex01 has JAX's inliers, cloud and
  colours, and its ``rect-*`` pixels are JAX's but in ROADMAP C's
  column-0 rows, as ``test_torch_png_depths.py`` holds them.
"""

import io
import pathlib
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

import chip_smoke
from sfmbench import scene
from spectavi_tpu_torch.pipeline import io as pio
from spectavi_tpu_torch.pipeline.jpeg import read_jpeg
from test_torch_jpeg import (SUBSAMPLING, _pillow_jpeg, _pixels, _same_as_pillow, cut_after_scan,
                             ex01_on_jax_matches_and_draws_vs_jax)
from test_torch_jpeg_progressive import FACTORS, FIXTURES, coded_jpeg

torch.set_num_threads(2)

SIZES = [(1, 1), (7, 13), (17, 9), (19, 20), (37, 33), (45, 67), (61, 83)]


def _cuts(data):
    """``data`` cut after each scan but its last."""
    return [cut_after_scan(data, k) for k in range(1, data.count(b"\xff\xda"))]


# --- Pillow's files, cut ---------------------------------------------------


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("sub", sorted(SUBSAMPLING))
@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_cut_files_equal_pillow(mode, sub, quality):
    rng = np.random.default_rng(quality + 7 * SUBSAMPLING[sub] + (100 if mode == "RGB" else 0))
    for h, w in SIZES:
        arr = _pixels(rng, h, w, 3 if mode == "RGB" else 1, noise=20)
        data = _pillow_jpeg(arr, quality=quality, subsampling=SUBSAMPLING[sub], progressive=True)
        cuts = _cuts(data)
        assert len(cuts) == (9 if mode == "RGB" else 5)
        for part in cuts:
            assert _same_as_pillow(part).shape == arr.shape


@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_cut_large_file_equals_pillow(mode):
    """599x800: many blocks between the edges, partial MCUs at both."""
    arr = _pixels(np.random.default_rng(30), 599, 800, 3 if mode == "RGB" else 1)
    for part in _cuts(_pillow_jpeg(arr, quality=85, progressive=True)):
        _same_as_pillow(part)


@pytest.mark.parametrize("restart", [{"restart_marker_blocks": 1}, {"restart_marker_blocks": 5},
                                     {"restart_marker_rows": 1}], ids=["blocks1", "blocks5", "rows1"])
@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_cut_files_with_restarts(mode, restart):
    rng = np.random.default_rng(31 + len(str(restart)))
    for sub in (0, 1, 2):
        for h, w in ((45, 67), (97, 131)):
            data = _pillow_jpeg(_pixels(rng, h, w, 3 if mode == "RGB" else 1), subsampling=sub,
                                progressive=True, **restart)
            assert b"\xff\xdd" in data
            for part in _cuts(data):
                _same_as_pillow(part)


def test_cut_file_is_smoothed():
    """The cut after the first scan holds DC only, so without smoothing
    every 8x8 block would be flat; libjpeg-turbo's "change DC" estimates
    give the blocks gradients, and the codec gives Pillow's pixels."""
    arr = _pixels(np.random.default_rng(32), 61, 83, 1, noise=20)
    data = _pillow_jpeg(arr, progressive=True)
    got = _same_as_pillow(cut_after_scan(data, 1))
    blocks = got[:56, :80].reshape(7, 8, 10, 8).astype(int)
    assert (blocks.max(axis=(1, 3)) - blocks.min(axis=(1, 3))).max() > 0


# --- files of this file's scan scripts --------------------------------------


def _scripts(nc):
    """The first scans ``(components, Ss, Se, Al)`` of each script for
    ``nc`` components."""
    every = list(range(nc))
    return {
        "band10-unrefined": [(every, 0, 0, 0)] + [s for i in every
                                                   for s in (([i], 1, 9, 0), ([i], 10, 63, 1))],
        "band9-unrefined": [(every, 0, 0, 0)] + [s for i in every
                                                  for s in (([i], 1, 8, 0), ([i], 9, 63, 1))],
        "dc-only": [(every, 0, 0, 0)],
        "dc-only-al2": [(every, 0, 0, 2)],
        "dc-each-component": [([i], 0, 0, 1) for i in every],
        "luma-ac-only": [(every, 0, 0, 0), ([0], 1, 63, 0)],
    }


SCRIPT_FACTORS = ["gray-2x2", "4:4:4", "4:2:2", "4:2:0", "4:4:0", "4:1:1", "chroma-h1v2-h2v1"]


@pytest.mark.parametrize("name", SCRIPT_FACTORS)
@pytest.mark.parametrize("script", sorted(_scripts(3)))
def test_scan_scripts_equal_pillow(script, name):
    factors = FACTORS[name]
    rng = np.random.default_rng(33 + len(script) + 10 * len(name))
    for h, w in ((1, 1), (5, 9), (37, 53), (70, 131)):
        for restart in (0, 2):
            data = coded_jpeg(rng, h, w, factors, restart=restart, progressive=True,
                              scans=_scripts(len(factors))[script])
            _same_as_pillow(data)


@pytest.mark.parametrize("zero", [0, 4, 9, 12, 63], ids=lambda z: f"zigzag{z}")
def test_zero_in_quantization_table(zero):
    """A zero at a position smoothing reads (zigzag 0-9) turns it off
    (``smoothing_ok``: no division by zero); one past it does not."""
    rng = np.random.default_rng(34 + zero)
    quant = [8] * 64
    quant[zero] = 0
    for name in ("gray-2x2", "4:2:0"):
        for script in ("band9-unrefined", "dc-only"):
            for h, w in ((5, 9), (37, 53)):
                data = coded_jpeg(rng, h, w, FACTORS[name], progressive=True, quant=quant,
                                  scans=_scripts(len(FACTORS[name]))[script])
                _same_as_pillow(data)


@settings(max_examples=40, deadline=None, derandomize=True)
@given(h=st.integers(1, 90), w=st.integers(1, 90), mode=st.sampled_from(["L", "RGB"]),
       sub=st.sampled_from([0, 1, 2]), quality=st.integers(1, 100),
       content=st.sampled_from(["smooth", "noise", "flat", "edges"]),
       restart=st.integers(0, 3), cut=st.floats(0, 1), seed=st.integers(0, 2 ** 16))
def test_random_cut_files_equal_pillow(h, w, mode, sub, quality, content, restart, cut, seed):
    rng = np.random.default_rng(seed)
    c = 3 if mode == "RGB" else 1
    if content == "smooth":
        arr = _pixels(rng, h, w, c).reshape(h, w, c)
    elif content == "noise":
        arr = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    elif content == "flat":
        arr = np.full((h, w, c), rng.integers(0, 256), np.uint8)
    else:
        arr = (rng.random((h, w, c)) < 0.5).astype(np.uint8) * 255
    kw = {"restart_marker_blocks": restart} if restart else {}
    data = _pillow_jpeg(arr[..., 0] if c == 1 else arr, quality=quality, subsampling=sub,
                        progressive=True, **kw)
    cuts = _cuts(data)
    _same_as_pillow(cuts[min(int(cut * len(cuts)), len(cuts) - 1)])


# --- the card's digests, and Pillow blocked --------------------------------


@pytest.mark.parametrize("name", sorted(chip_smoke.JPEG_SMOOTH_SHA256))
def test_chip_smoke_smooth_digests_are_pillows(name):
    data = (FIXTURES / name).read_bytes()
    assert b"\xff\xc2" in data
    pillow = lambda b: np.asarray(Image.open(io.BytesIO(b)))
    assert chip_smoke.jpeg_smooth_digest(np, data, pillow) == chip_smoke.JPEG_SMOOTH_SHA256[name]
    assert chip_smoke.jpeg_smooth_digest(np, data, read_jpeg) == chip_smoke.JPEG_SMOOTH_SHA256[name]
    assert chip_smoke.cut_after_scan(data, 2) == cut_after_scan(data, 2)


def test_cut_files_without_pillow(tmp_path, monkeypatch):
    arr = _pixels(np.random.default_rng(35), 45, 67, 3)
    paths, refs = [], []
    for k, part in enumerate(_cuts(_pillow_jpeg(arr, progressive=True))):
        paths.append(str(tmp_path / f"cut{k}.jpg"))
        pathlib.Path(paths[-1]).write_bytes(part)
        refs.append(np.asarray(Image.open(paths[-1])))
    monkeypatch.setitem(sys.modules, "PIL", None)
    pio._decode.cache_clear()
    with pytest.raises(ImportError):
        pio._pillow()
    for p, ref in zip(paths, refs):
        got = pio.imread(p, dtype="uint8")
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


# --- ex01 from smoothed files against the JAX package -----------------------


@pytest.fixture(scope="module")
def smoothed_pair(tmp_path_factory):
    """The rendered 240x320 pair of ``test_sfm_pipeline._tiny_dataset`` as
    progressive RGB JPEG (Pillow, quality 90) cut after scan 5 (Y's AC
    6-63 at Al 2: Y's first band and the chroma bands unrefined)."""
    from test_sfm_pipeline import _tiny_dataset

    tmp = tmp_path_factory.mktemp("smoothed_pair")
    pngs, kfile, _ = _tiny_dataset(tmp, np.random.default_rng(0xDEADBEEF), nviews=2, H=240,
                                   W=320)
    paths = []
    for i, p in enumerate(pngs):
        rgb = scene.as_rgb(np.asarray(Image.open(p)))
        paths.append(str(tmp / f"s{i}.jpg"))
        data = _pillow_jpeg(rgb, quality=90, progressive=True)
        pathlib.Path(paths[-1]).write_bytes(cut_after_scan(data, chip_smoke.PAIR_CUT_SCAN))
    return tmp, paths, kfile, None


def test_smoothed_pair_decodes_are_jax_arrays(smoothed_pair):
    from spectavi_tpu.pipeline.io import imread as jax_imread

    for p in smoothed_pair[1]:
        for kw in ({"dtype": "uint8"}, {"dtype": "float32", "force_grayscale": True}):
            got, want = pio.imread(p, **kw), np.asarray(jax_imread(p, **kw))
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)


def test_ex01_smoothed_pair_vs_jax(smoothed_pair, monkeypatch):
    ex01_on_jax_matches_and_draws_vs_jax(smoothed_pair, monkeypatch)
