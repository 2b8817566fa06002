"""The port's JPEG decoder (``csrc/jpeg_host.cpp``) on progressive files
and on every integral sampling factor, against Pillow, and the
pipelines from progressive files against the JAX package.

* Decode: every element equal, with dtype and shape, to
  ``np.asarray(Image.open(f))`` for Pillow's progressive files (gray and
  RGB at 4:4:4, 4:2:2 and 4:2:0, quality 50, 75 and 95, sizes 1x1 to
  599x800, with restart markers), the progressive castle file, Pillow's
  4:2:2 and 4:2:0 files with their frame header patched to 4:4:0, 4:1:1
  and 1x4 (the same MCU count and block order), files that a small
  entropy coder here writes at any sampling factors (sequential and
  progressive), and a bounded ``hypothesis`` search.
* Progressive files cut after scan k (coefficients left unrefined,
  which libjpeg-turbo smooths) are the codec's: ``read_jpeg`` and
  ``imread`` give Pillow's array, with Pillow blocked too (in a
  subprocess), as for complete progressive files
  (``test_torch_jpeg_smoothing.py`` holds the smoothing to Pillow).
  Non-integral sampling factors give None.
* Malformed progressive files raise ``ValueError`` in a subprocess that
  exits cleanly; so does a progressive file without DHT (Pillow fails
  too) and a file whose coefficients drive the inverse DCT past the
  8-bit range (where libjpeg-turbo's C and SIMD builds disagree).
* The fixtures under ``tests/data/jpeg/`` (which the card's machine,
  without Pillow, decodes in ``chip_smoke.py``): Pillow's decode of each
  equals its pinned digest, and :func:`small_fixtures` writes the same
  bytes.  ``PYTHONPATH=. python tests/test_torch_jpeg_progressive.py``
  from the repository's root writes them all, the rendered 2048x3072
  pair too (~2 min and ~4 GB on a CPU).
* From the 3 rendered 120x160 views as progressive RGB JPEG: ex01 and
  ex02 as CLIs with Pillow blocked; ex01 given JAX's matches and RANSAC
  draws, and ``run_sfm`` given JAX's draws, against the JAX package's,
  under ``test_torch_jpeg.py``'s rules.
"""

import hashlib
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
from test_torch_jpeg import (CASTLE, SIZES, SUBSAMPLING, _pillow_jpeg, _pixels, _run_blocked,
                             _same_as_pillow, _without, clis_without_pillow, cut_after_scan,
                             ex01_on_jax_matches_and_draws_vs_jax, make_jpeg_views,
                             run_sfm_vs_jax)

torch.set_num_threads(2)

FIXTURES = pathlib.Path(__file__).resolve().parent / "data" / "jpeg"
# sha256 of np.asarray(Image.open(f)).tobytes() for each fixture, with
# Pillow 12.1.0 on libjpeg-turbo 3.1.3 (chip_smoke.py pins the same)
FIXTURE_SHA256 = {
    "castle-progressive.jpg": "07daa172b1e009ff4d601223f4ba1b025bda349cf058ea5f2594253dd5a0a5cb",
    "digest-gray-progressive-rst3.jpg": "979d44478f24f09e304e81e11b1c0fc2d327919aecfa50183bbc6d827eafcc37",
    "digest-rgb-411.jpg": "4d0d60279e998190c09399bc666516d71bf3451e05d2ce6b7fa9f4b363235451",
    "digest-rgb-440-progressive.jpg": "0ba416f831ca538ff4b749402cc69e5b9a36b6c50056ce80d50799600d94a1e4",
    "digest-rgb-440.jpg": "f01c5c6fd9c76bb8a5d1b77cc1fe17f850b50aa2f921c1cabefa6b47c85b2089",
    "digest-rgb-progressive-444.jpg": "e0db1599f169c4e3f5fb16874005a5b06f3582b112b2a0e1073576c9a694038a",
    "digest-rgb-progressive-rst3.jpg": "5ef507b0f3c0b8a1344e88b2bb1fa2cea7f93da5237e1654413e557fdbd43655",
    "pair0.jpg": "31323d6aeac5856d3e928cb1b03738eb2c7b2010140642177d9dc0c271f01b81",
    "pair1.jpg": "d78c886718a247c36af126eaa7fb44bb0f223b66615d1a4eda077babb742290d",
}
PAIR_QUALITY = 90


# --- files -------------------------------------------------------------


def sof_patch(data, w, h, luma):
    """``data`` with its frame header saying ``w`` x ``h`` and luma
    sampling byte ``luma``."""
    i = data.index(b"\xff\xc2" if b"\xff\xc2" in data else b"\xff\xc0")
    b = bytearray(data)
    b[i + 5:i + 7] = h.to_bytes(2, "big")
    b[i + 7:i + 9] = w.to_bytes(2, "big")
    b[i + 11] = luma
    return bytes(b)


# the size and luma byte that keep a Pillow file's MCU count and block
# order, from its (h, w): 4:4:0 from 4:2:2, 4:1:1 and 1x4 from 4:2:0;
# a progressive file also keeps every component's block count when it
# is 4:4:0, or 4:1:1 / 1x4 with h and w multiples of 16
PATCHES = {
    "4:4:0": (1, lambda h, w: (h, w), 0x12),
    "4:1:1": (2, lambda h, w: (2 * w, (h + 1) // 2), 0x41),
    "1x4": (2, lambda h, w: ((w + 1) // 2, 2 * h), 0x14),
}


def patched(arr, name, **kw):
    sub, size, luma = PATCHES[name]
    return sof_patch(_pillow_jpeg(arr, subsampling=sub, **kw), *size(*arr.shape[:2]), luma)


def _huffman(symbols, length):
    """A DHT body and ``{symbol: (code, length)}``: every symbol coded
    in ``length`` bits."""
    counts = [0] * 16
    counts[length - 1] = len(symbols)
    return bytes(counts) + bytes(symbols), {s: (i, length) for i, s in enumerate(symbols)}


_DC_TABLE = _huffman(range(12), 4)
# run/size symbols, end-of-band runs EOBn and ZRL
_AC_TABLE = _huffman(sorted({0x00, 0xF0} | {(r << 4) | s for r in range(16) for s in range(1, 11)}
                            | {r << 4 for r in range(15)}), 8)


class _Bits:
    """MSB-first bits with FF 00 stuffing, padded with ones."""

    def __init__(self):
        self.acc, self.n, self.out = 0, 0, bytearray()

    def put(self, value, n):
        self.acc = (self.acc << n) | (value & ((1 << n) - 1))
        self.n += n
        while self.n >= 8:
            self.n -= 8
            b = (self.acc >> self.n) & 255
            self.out += bytes([b, 0]) if b == 255 else bytes([b])
        self.acc &= (1 << self.n) - 1

    def code(self, table, symbol):
        self.put(*table[1][symbol])

    def value(self, v):
        """The category's extra bits of ``v``; returns the category."""
        s = abs(int(v)).bit_length()
        self.put(v if v >= 0 else v + (1 << s) - 1, s)
        return s

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def _segment(marker, body):
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def coded_jpeg(rng, h, w, factors, restart=0, progressive=False, eob_run=None, scans=None,
               quant=None):
    """A JPEG of random quantized coefficients with ``factors`` ((h, v)
    a component) written here: JFIF, a flat quantization table (or
    ``quant``, 64 values in zigzag order), one DC and one AC table with
    every code 4 and 8 bits long.  Sequential: one scan.  Progressive: a
    DC scan of every component, then one AC scan of the whole band for
    each, all at Al = 0 (so nothing is left unrefined), or the first
    scans ``scans``, ``(components, Ss, Se, Al)`` each, whose bands no
    later scan refines.  ``eob_run``: the first AC scan is one
    end-of-band run of that many blocks and no coefficient has AC."""
    nc = len(factors)
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    coefs = []
    for fh, fv in factors:
        c = np.zeros((mcuy * fv, mcux * fh, 64), np.int64)  # zigzag order
        c[..., 0] = rng.integers(-40, 41, c.shape[:2])
        if eob_run is None:
            ac = rng.integers(-6, 7, c.shape[:2] + (14,))
            c[..., 1:15] = ac * (rng.random(ac.shape) < 0.4)
        coefs.append(c)
    sof = bytes([8, *h.to_bytes(2, "big"), *w.to_bytes(2, "big"), nc])
    for i, (fh, fv) in enumerate(factors):
        sof += bytes([i + 1, (fh << 4) | fv, 0])
    out = (b"\xff\xd8" + _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
           + _segment(0xDB, bytes([0] + (quant or [8] * 64)))
           + _segment(0xC2 if progressive else 0xC0, sof)
           + _segment(0xC4, b"\x00" + _DC_TABLE[0]) + _segment(0xC4, b"\x10" + _AC_TABLE[0]))
    if restart:
        out += _segment(0xDD, restart.to_bytes(2, "big"))
    if scans is None:
        scans = ([(list(range(nc)), 0, 0, 0)] + [([i], 1, 63, 0) for i in range(nc)]
                 if progressive else [(list(range(nc)), 0, 63, 0)])
    for comps, ss, se, al in scans:
        if len(comps) > 1:
            mcus = [[(i, coefs[i][my * factors[i][1] + y, mx * factors[i][0] + x])
                     for i in comps for y in range(factors[i][1]) for x in range(factors[i][0])]
                    for my in range(mcuy) for mx in range(mcux)]
        else:
            i = comps[0]
            cw, ch = -(-w * factors[i][0] // hmax), -(-h * factors[i][1] // vmax)
            mcus = [[(i, coefs[i][by, bx])] for by in range(-(-ch // 8))
                    for bx in range(-(-cw // 8))]
        bits, data, pred = _Bits(), b"", [0] * nc
        for n, mcu in enumerate(mcus):
            if restart and n and n % restart == 0:
                data += bits.flush() + bytes([0xFF, 0xD0 + (n // restart - 1) % 8])
                bits, pred = _Bits(), [0] * nc
            for i, blk in mcu:
                if ss == 0:
                    # the point transform: DC shifted, AC magnitudes shifted
                    dc = int(blk[0]) >> al
                    diff, pred[i] = dc - pred[i], dc
                    s = abs(int(diff)).bit_length()
                    bits.code(_DC_TABLE, s)
                    bits.value(diff)
                if se == 0:
                    continue
                if eob_run is not None and comps == [0]:
                    if n == 0:
                        r = eob_run.bit_length() - 1
                        bits.code(_AC_TABLE, r << 4)
                        bits.put(eob_run - (1 << r), r)
                    continue
                run = 0
                for k in range(max(ss, 1), se + 1):
                    v = int(np.sign(blk[k])) * (abs(int(blk[k])) >> al)
                    if v == 0:
                        run += 1
                        continue
                    while run > 15:
                        bits.code(_AC_TABLE, 0xF0)
                        run -= 16
                    s = abs(v).bit_length()
                    bits.code(_AC_TABLE, (run << 4) | s)
                    bits.value(v)
                    run = 0
                if run:
                    bits.code(_AC_TABLE, 0x00)
        data += bits.flush()
        sos = bytes([len(comps)]) + b"".join(bytes([i + 1, 0x00]) for i in comps)
        out += _segment(0xDA, sos + bytes([ss, se, al])) + data
    return out + b"\xff\xd9"


# --- decode against Pillow -----------------------------------------------


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("sub", sorted(SUBSAMPLING))
@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_progressive_decode_equals_pillow(mode, sub, quality):
    rng = np.random.default_rng(quality + 7 * SUBSAMPLING[sub] + (100 if mode == "RGB" else 0))
    for h, w in SIZES:
        arr = _pixels(rng, h, w, 3 if mode == "RGB" else 1)
        data = _pillow_jpeg(arr, quality=quality, subsampling=SUBSAMPLING[sub], progressive=True)
        assert data[2:].find(b"\xff\xc2") > 0
        assert _same_as_pillow(data).shape == arr.shape


@pytest.mark.parametrize("restart", [{"restart_marker_blocks": 1}, {"restart_marker_blocks": 7},
                                     {"restart_marker_rows": 1}], ids=["blocks1", "blocks7", "rows1"])
@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_progressive_restarts(mode, restart):
    rng = np.random.default_rng(17 + len(str(restart)))
    for sub in (0, 1, 2):
        for h, w in ((45, 67), (97, 131), (240, 320)):
            arr = _pixels(rng, h, w, 3 if mode == "RGB" else 1)
            data = _pillow_jpeg(arr, subsampling=sub, progressive=True, **restart)
            assert b"\xff\xdd" in data and b"\xff\xd0" in data
            _same_as_pillow(data)


def test_progressive_castle_file():
    data = (FIXTURES / "castle-progressive.jpg").read_bytes()
    got = _same_as_pillow(data)
    assert got.shape == (599, 800, 3)
    assert hashlib.sha256(got.tobytes()).hexdigest() == FIXTURE_SHA256["castle-progressive.jpg"]


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("name", sorted(PATCHES))
def test_patched_sampling_factors(name, progressive):
    """Pillow's files with the frame header patched: libjpeg-turbo's
    h1v2 fancy upsampling (4:4:0) and its replication (4:1:1, 1x4)."""
    rng = np.random.default_rng(18 + len(name) + 10 * progressive)
    sizes = ((48, 64), (64, 64), (96, 160)) if progressive and name != "4:4:0" else (
        (1, 1), (7, 13), (45, 67), (48, 64), (97, 131), (130, 250))
    for h, w in sizes:
        for restart in ({}, {"restart_marker_blocks": 3}, {"restart_marker_rows": 1}):
            data = patched(_pixels(rng, h, w, 3), name, progressive=progressive, **restart)
            got = _same_as_pillow(data)
            assert got.shape == (*PATCHES[name][1](h, w)[::-1], 3)


# (Y, Cb, Cr) or (Y,) sampling factors: every routine of jinit_upsampler
FACTORS = {
    "4:4:4": ((1, 1), (1, 1), (1, 1)),
    "4:2:2": ((2, 1), (1, 1), (1, 1)),
    "4:4:0": ((1, 2), (1, 1), (1, 1)),
    "4:2:0": ((2, 2), (1, 1), (1, 1)),
    "4:1:1": ((4, 1), (1, 1), (1, 1)),
    "1x4": ((1, 4), (1, 1), (1, 1)),
    "4x2": ((4, 2), (1, 1), (1, 1)),
    "2x4": ((2, 4), (1, 1), (1, 1)),
    "3x1": ((3, 1), (1, 1), (1, 1)),
    "1x3": ((1, 3), (1, 1), (1, 1)),
    "3x2": ((3, 2), (1, 1), (1, 1)),
    "chroma-h1v2-h2v1": ((2, 2), (2, 1), (1, 2)),
    "chroma-4x1-2x1": ((4, 1), (2, 1), (1, 1)),
    "luma-upsampled": ((1, 1), (2, 2), (1, 1)),
    "all-2x1": ((2, 1), (2, 1), (2, 1)),
    "gray-2x2": ((2, 2),),
    "gray-4x3": ((4, 3),),
}


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("name", sorted(FACTORS))
def test_any_integral_sampling_factors(name, progressive):
    rng = np.random.default_rng(19 + len(name) + 10 * progressive)
    for h, w in ((1, 1), (5, 9), (37, 53), (70, 131)):
        for restart in (0, 2):
            data = coded_jpeg(rng, h, w, FACTORS[name], restart=restart, progressive=progressive)
            got = _same_as_pillow(data)
            assert got.shape == ((h, w) if len(FACTORS[name]) == 1 else (h, w, 3))


@pytest.mark.parametrize("factors", [((3, 1), (2, 1), (1, 1)), ((2, 3), (1, 2), (1, 1))],
                         ids=["3x1-2x1", "2x3-1x2"])
def test_non_integral_sampling_goes_to_pillow(factors):
    """libjpeg-turbo refuses them too (JERR_FRACT_SAMPLE_NOTIMPL)."""
    data = coded_jpeg(np.random.default_rng(20), 37, 53, factors)
    assert read_jpeg(data) is None
    with pytest.raises(OSError):
        np.asarray(Image.open(io.BytesIO(data)))


def test_mcu_of_more_than_ten_blocks_raises():
    """libjpeg-turbo's JERR_BAD_MCU_SIZE: 3x3 luma and two chroma blocks."""
    data = coded_jpeg(np.random.default_rng(21), 37, 53, ((3, 3), (1, 1), (1, 1)))
    with pytest.raises(ValueError, match="10 blocks"):
        read_jpeg(data)
    with pytest.raises(OSError):
        np.asarray(Image.open(io.BytesIO(data)))


@settings(max_examples=40, deadline=None, derandomize=True)
@given(h=st.integers(1, 90), w=st.integers(1, 90), mode=st.sampled_from(["L", "RGB"]),
       sub=st.sampled_from([0, 1, 2]), quality=st.integers(1, 100),
       content=st.sampled_from(["smooth", "noise", "flat", "edges"]),
       restart=st.integers(0, 3), progressive=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_decode_random_files_equal_pillow(h, w, mode, sub, quality, content, restart,
                                          progressive, seed):
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
    arr = arr[..., 0] if c == 1 else arr
    kw = {"restart_marker_blocks": restart} if restart else {}
    _same_as_pillow(_pillow_jpeg(arr, quality=quality, subsampling=sub, progressive=progressive,
                                 **kw))


# --- cut progressive files ------------------------------------------------


@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_partial_scans_go_to_pillow(tmp_path, mode):
    """Pillow's progressive file cut after scan k: libjpeg-turbo smooths
    the blocks whose coefficients are not refined, and so does the codec
    (the file no longer goes to Pillow)."""
    arr = _pixels(np.random.default_rng(22), 61, 83, 3 if mode == "RGB" else 1)
    data = _pillow_jpeg(arr, progressive=True)
    scans = data.count(b"\xff\xda")
    assert scans == (10 if mode == "RGB" else 6)
    full = np.asarray(Image.open(io.BytesIO(data)))
    for k in range(1, scans):
        part = cut_after_scan(data, k)
        _same_as_pillow(part)
        path = tmp_path / f"{k}.jpg"
        path.write_bytes(part)
        ref = np.asarray(Image.open(path))
        assert not np.array_equal(ref, full)
        got = pio.imread(str(path), dtype="uint8")
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(read_jpeg(cut_after_scan(data, scans)), full)


def test_progressive_without_pillow(tmp_path):
    """With Pillow blocked, complete progressive files (and a patched
    4:4:0 one) are read, and so is one with unrefined coefficients."""
    rng = np.random.default_rng(23)
    files = {"gray": _pillow_jpeg(_pixels(rng, 29, 35, 1), progressive=True),
             "rgb": _pillow_jpeg(_pixels(rng, 29, 35, 3), progressive=True),
             "rgb-440": patched(_pixels(rng, 29, 35, 3), "4:4:0", progressive=True)}
    files["unrefined"] = cut_after_scan(files["rgb"], 3)
    for name, data in files.items():
        (tmp_path / f"{name}.jpg").write_bytes(data)
    code = (
        "import numpy as np\n"
        "from spectavi_tpu_torch.pipeline.io import imread\n"
        f"d = {str(tmp_path)!r}\n"
        f"for n in {sorted(files)!r}:\n"
        "    np.save(f'{d}/{n}.npy', imread(f'{d}/{n}.jpg', dtype='uint8'))\n")
    out = _run_blocked(code)
    assert out.returncode == 0, out.stderr
    for name in files:
        np.testing.assert_array_equal(np.load(tmp_path / f"{name}.npy"),
                                      np.asarray(Image.open(tmp_path / f"{name}.jpg")))


# --- malformed progressive files -----------------------------------------


def _scan_starts(data):
    """Offsets of each SOS marker."""
    out, pos = [], 0
    while (pos := data.find(b"\xff\xda", pos)) >= 0:
        out.append(pos)
        pos += 2
    return out


def _with(data, offset, value):
    b = bytearray(data)
    b[offset] = value
    return bytes(b)


def _malformed(how):
    """Progressive files that the decoder must refuse with ValueError.
    An SOS of ``ns`` components holds Ss, Se and Ah/Al at ``5 + 2 ns``,
    ``6 + 2 ns`` and ``7 + 2 ns``."""
    rng = np.random.default_rng(24)
    data = _pillow_jpeg(_pixels(rng, 45, 67, 3), progressive=True, restart_marker_blocks=4)
    sos = _scan_starts(data)
    dc, ac = sos[0], sos[1]  # the DC scan of 3 components; Y's AC 1-5 at Al = 2
    if how == "truncated":
        return [data[:k] for k in range(sos[0] + 14, len(data) - 1, 97)] + [data[:-1]]
    if how == "ss-above-se":
        return [_with(_with(data, ac + 7, 5), ac + 8, 1)]
    if how == "se-64":
        return [_with(data, ac + 8, 64)]
    if how == "al-14":
        return [_with(data, dc + 13, 0x0E)]
    if how == "dc-se-nonzero":
        return [_with(data, dc + 12, 5)]
    if how == "ac-two-components":
        # the DC scan's three components given an AC band
        return [_with(_with(data, dc + 11, 1), dc + 12, 5)]
    if how == "refine-before-first":
        # Y's AC 1-5 as a refinement (Ah 3, Al 2) before any first scan
        return [_with(data, ac + 9, 0x32)]
    if how == "huffman-ac-refine":
        # sixteen 1 bits open the last scan (Y's AC refinement): no code
        last = sos[-1]
        start = last + 2 + int.from_bytes(data[last + 2:last + 4], "big")
        return [data[:start] + b"\xff\x00" * 4 + data[start + 4:]]
    if how == "eob-run-past-end":
        # 3x4 blocks, and an end-of-band run of 13 in Y's AC scan
        return [coded_jpeg(rng, 32, 24, ((1, 1),), progressive=True, eob_run=13)]
    raise ValueError(how)


MALFORMED = ["truncated", "ss-above-se", "se-64", "al-14", "dc-se-nonzero", "ac-two-components",
             "refine-before-first", "huffman-ac-refine", "eob-run-past-end"]


@pytest.fixture(scope="module")
def malformed_results(tmp_path_factory):
    """Every malformed file read in one subprocess: its exit code and
    ``{how: [line a file]}``."""
    tmp = tmp_path_factory.mktemp("malformed")
    names = []
    for how in MALFORMED:
        for i, data in enumerate(_malformed(how)):
            names.append(f"{how}.{i}")
            (tmp / f"{names[-1]}.jpg").write_bytes(data)
    code = (
        "from spectavi_tpu_torch.pipeline.jpeg import read_jpeg\n"
        f"for name in {names!r}:\n"
        f"    data = open(f'{tmp}/{{name}}.jpg', 'rb').read()\n"
        "    try:\n"
        "        read_jpeg(data)\n"
        "        print(name, 'decoded')\n"
        "    except ValueError as e:\n"
        "        print(name, 'ValueError', e)\n")
    out = _run_blocked(code, blocked=())
    lines = {how: [] for how in MALFORMED}
    for line in out.stdout.splitlines():
        lines[line.split(".")[0]].append(line)
    return out, lines, names


@pytest.mark.parametrize("how", MALFORMED)
def test_malformed_progressive_raises_cleanly(malformed_results, how):
    out, lines, names = malformed_results
    # a crash would end the interpreter on a signal: a negative code
    assert out.returncode == 0, out.stderr[-3000:]
    assert len(lines[how]) == sum(n.split(".")[0] == how for n in names) > 0
    assert all(" ValueError " in line for line in lines[how]), [
        x for x in lines[how] if "decoded" in x]


def test_progressive_file_without_dht_raises():
    """libjpeg-turbo gives progressive scans no Annex K tables (only
    sequential ones, as Motion-JPEG needs): Pillow fails, the codec
    raises."""
    data = _without(coded_jpeg(np.random.default_rng(25), 37, 53, ((2, 2), (1, 1), (1, 1)),
                               progressive=True), {0xC4})
    assert b"\xff\xc4" not in data
    with pytest.raises(ValueError, match="Huffman table"):
        read_jpeg(data)
    with pytest.raises(OSError):
        np.asarray(Image.open(io.BytesIO(data)))


@pytest.mark.parametrize("progressive", [False, True])
def test_coefficients_beyond_8_bit_range_raise(progressive):
    """Coefficients no 8-bit encoder writes (here a quantization table
    of 255s under coefficients made for 8s) drive the inverse DCT past
    +-512, where libjpeg-turbo's C arithmetic wraps and its SIMD build
    saturates: Pillow gives pixels, the codec raises rather than give
    others."""
    data = coded_jpeg(np.random.default_rng(26), 37, 53, ((2, 1), (1, 1), (1, 1)),
                      progressive=progressive)
    flat = bytes([0] + [8] * 64)
    assert data.count(flat) == 1
    data = data.replace(flat, bytes([0] + [255] * 64))
    assert np.asarray(Image.open(io.BytesIO(data))).shape == (37, 53, 3)
    with pytest.raises(ValueError, match="8-bit samples"):
        read_jpeg(data)


def test_eob_run_that_ends_in_the_scan_decodes():
    """The same file as ``eob-run-past-end`` with the run of its 12 blocks."""
    data = coded_jpeg(np.random.default_rng(24), 32, 24, ((1, 1),), progressive=True, eob_run=12)
    _same_as_pillow(data)


# --- the fixtures ------------------------------------------------------------


def small_fixtures():
    """``{name: bytes}`` of every fixture but the pair's two images."""
    rgb, gray = chip_smoke.jpeg_digest_arrays(np)
    castle = np.asarray(Image.open(CASTLE))
    poses = [scene.arc_pose(i, 2) for i in range(2)]
    R, t = scene.relative_pose(poses)
    files = {
        "castle-progressive.jpg": _pillow_jpeg(castle, progressive=True, quality=95),
        "digest-rgb-progressive-rst3.jpg": _pillow_jpeg(rgb, progressive=True,
                                                        restart_marker_blocks=3),
        "digest-gray-progressive-rst3.jpg": _pillow_jpeg(gray, progressive=True,
                                                         restart_marker_blocks=3),
        "digest-rgb-progressive-444.jpg": _pillow_jpeg(rgb, progressive=True, subsampling=0),
        "digest-rgb-440.jpg": patched(rgb, "4:4:0"),
        "digest-rgb-411.jpg": patched(rgb, "4:1:1"),
        "digest-rgb-440-progressive.jpg": patched(rgb, "4:4:0", progressive=True),
    }
    for name, arr in (("K.txt", scene.camera_K(chip_smoke.H, chip_smoke.W)),
                      ("pose.txt", np.column_stack([R, t]))):
        f = io.BytesIO()
        np.savetxt(f, arr)
        files[name] = f.getvalue()
    return files


def pair_fixtures():
    """The rendered 2048x3072 pair of ``chip_smoke.py`` as progressive
    RGB JPEG at quality 90, 4:2:0: ``{name: bytes}``."""
    _, colors, _, _ = chip_smoke.render_pair(chip_smoke.H, chip_smoke.W, "cpu", chip_smoke.TEX)
    return {f"pair{i}.jpg": _pillow_jpeg(scene.as_rgb(c), progressive=True,
                                         quality=PAIR_QUALITY) for i, c in enumerate(colors)}


def test_fixtures_regenerate():
    """The committed files are what :func:`small_fixtures` writes (the
    pair's images are held by their digests below)."""
    files = small_fixtures()
    assert sorted(p.name for p in FIXTURES.iterdir()) == sorted([*files, "pair0.jpg",
                                                                 "pair1.jpg"])
    for name, data in files.items():
        assert (FIXTURES / name).read_bytes() == data, name


@pytest.mark.parametrize("name", sorted(FIXTURE_SHA256))
def test_fixture_digests(name):
    data = (FIXTURES / name).read_bytes()
    ref = np.asarray(Image.open(io.BytesIO(data)))
    assert hashlib.sha256(ref.tobytes()).hexdigest() == FIXTURE_SHA256[name]
    _same_as_pillow(data)
    assert chip_smoke.JPEG_FIXTURE_SHA256[name] == FIXTURE_SHA256[name]
    if name.startswith("pair"):
        assert ref.shape == (chip_smoke.H, chip_smoke.W, 3) and b"\xff\xc2" in data


# --- the pipelines from progressive files --------------------------------


@pytest.fixture(scope="module")
def progressive_views(tmp_path_factory):
    return make_jpeg_views(tmp_path_factory.mktemp("progressive_views"), progressive=True)


def test_views_are_progressive(progressive_views):
    for p in progressive_views[1]:
        data = pathlib.Path(p).read_bytes()
        assert b"\xff\xc2" in data
        _same_as_pillow(data)


def test_clis_without_pillow(progressive_views, tmp_path):
    clis_without_pillow(progressive_views, tmp_path)


def test_ex01_on_jax_matches_and_draws_vs_jax(progressive_views, monkeypatch):
    ex01_on_jax_matches_and_draws_vs_jax(progressive_views, monkeypatch)


def test_run_sfm_vs_jax(progressive_views, monkeypatch):
    run_sfm_vs_jax(progressive_views, monkeypatch)


if __name__ == "__main__":
    FIXTURES.mkdir(parents=True, exist_ok=True)
    written = {**small_fixtures(), **({} if "--small" in sys.argv else pair_fixtures())}
    for fname, fdata in written.items():
        (FIXTURES / fname).write_bytes(fdata)
        print(fname, len(fdata))
