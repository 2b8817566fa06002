"""The port's PNG codec (``spectavi_tpu_torch.pipeline.io``) against Pillow.

* Decode: every colour type at 8 bits (gray, RGB, palette, gray + alpha,
  RGBA), each with every row written with one of the five filters, with
  a random filter a row over several IDAT chunks beside ancillary
  chunks, and as Pillow saves it, gives exactly Pillow's array
  (``np.asarray(Image.open(f))``): values, dtype and shape.  Pillow has
  no option that forces a row filter, so those files come from this
  file's own encoder (``_png``: any bit depth, Adam7, any filter a row)
  and Pillow's decode is the reference.  The repository's own PNGs agree
  too.  ``tests/test_torch_png_depths.py`` holds the other bit depths
  and Adam7 to Pillow.
* The writer (``imsave``): gray, gray + alpha, RGB and RGBA files that
  Pillow reads back to the same pixels.
* The variants that went to Pillow before the codec read them: 16-bit
  and interlaced PNG now decode in the codec, with Pillow unreachable; a
  progressive CMYK JPEG (4 components) still goes to Pillow.  Malformed files raise
  ``ValueError``: a bad CRC, a truncated file, no IDAT, a bad filter
  type, too little data, a colour type and bit depth PNG does not pair,
  image data that does not inflate, an Adam7 stream one byte short,
  sub-byte rows of the wrong length.
* With Pillow blocked (``sys.modules["PIL"] = None``, in a subprocess):
  ``imread`` of an 8-bit, a 16-bit and an Adam7 PNG and of a baseline
  JPEG works, and of such a progressive CMYK JPEG raises an
  ``ImportError`` that names Pillow; ex01 from 8-bit, 16-bit and Adam7
  pairs and ex02 from 8-bit, 16-bit and Adam7 views run on the CPU and
  write what the runs with Pillow present write; ex01 ``--plots`` with
  matplotlib blocked raises before SIFT runs.
"""

import io
import os
import pathlib
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from spectavi_tpu_torch.pipeline import io as pio

ROOT = pathlib.Path(__file__).resolve().parents[1]
# colour type -> (channels, Pillow mode)
TYPES = {0: (1, "L"), 2: (3, "RGB"), 3: (1, "P"), 4: (2, "LA"), 6: (4, "RGBA")}
PALETTE = bytes(np.random.default_rng(7).integers(0, 256, 3 * 40, dtype=np.uint8))


def _pixels(rng, ctype, h=37, w=53, depth=8):
    """A smooth image with noise (so every predictor matters), as
    samples of ``depth`` bits: uint8, or uint16 at 16 bits."""
    ch = TYPES[ctype][0]
    if ctype == 3:
        return rng.integers(0, min(40, 1 << depth), (h, w), dtype=np.uint8)
    x = np.cumsum(rng.integers(-9, 10, (h, w, ch)), axis=1) + np.cumsum(
        rng.integers(-9, 10, (h, 1, ch)), axis=0)
    if depth == 16:  # 16 bits with signal in the low byte
        x = (x * 211 + rng.integers(0, 256, x.shape)) % 65536
    else:
        x = (x - x.min()) % (1 << depth)
    x = x.astype(np.uint16 if depth == 16 else np.uint8)
    return x[..., 0] if ch == 1 else x


def _pack(samples, depth, pad_bits=False):
    """Rows of samples ``(h, w[, C])`` as the PNG stream stores them: 16
    bits big-endian, below 8 bits packed most significant bits first,
    the padding bits of each row's last byte set when ``pad_bits``."""
    h, w = samples.shape[:2]
    x = samples.reshape(h, -1)
    if depth == 16:
        return x.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return x.astype(np.uint8)
    per = 8 // depth
    n = -(-x.shape[1] // per)
    padded = np.full((h, n * per), (1 << depth) - 1 if pad_bits else 0, np.int64)
    padded[:, :x.shape[1]] = x
    shifts = np.arange(8 - depth, -1, -depth)
    return (padded.reshape(h, n, per) << shifts).sum(axis=2).astype(np.uint8)


def _filter_row(cur, prev, f, bpp):
    """One row filtered with type ``f`` (the PNG specification's
    formulas, byte by byte on the original bytes)."""
    out = np.zeros(len(cur), np.int64)
    for i in range(len(cur)):
        a = int(cur[i - bpp]) if i >= bpp else 0
        b = int(prev[i])
        c = int(prev[i - bpp]) if i >= bpp else 0
        if f == 0:
            p = 0
        elif f == 1:
            p = a
        elif f == 2:
            p = b
        elif f == 3:
            p = (a + b) // 2
        else:
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            p = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (int(cur[i]) - p) % 256
    return out.astype(np.uint8)


def _chunk(ctype, body):
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(
        ">I", zlib.crc32(ctype + body))


# Adam7's passes: first row, first column, row step, column step
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
         (1, 0, 2, 1))


def _png(arr, ctype, filters, idat_parts=1, extra=(), depth=8, interlace=0, pad_bits=False,
         palette=PALETTE, raw_hook=None):
    """A PNG of the samples ``arr`` at ``depth`` bits, Adam7-interlaced
    when ``interlace``, the ``k``-th row of the stream (counting across
    passes) filtered by ``filters[k % len(filters)]``, its data split
    over ``idat_parts`` IDAT chunks, ``extra`` chunks (name, body)
    written before the first; ``raw_hook`` edits the filtered stream
    before it is compressed."""
    h, w = arr.shape[:2]
    bpp = max(1, TYPES[ctype][0] * depth // 8)
    raw, k = b"", 0
    for y0, x0, dy, dx in ADAM7 if interlace else ((0, 0, 1, 1),):
        sub = arr[y0::dy, x0::dx]
        if not sub.size:
            continue
        rows = _pack(sub, depth, pad_bits)
        prev = np.zeros(rows.shape[1], np.uint8)
        for r in rows:
            f = int(filters[k % len(filters)])
            raw += bytes([f]) + _filter_row(r, prev, f, bpp).tobytes()
            prev, k = r, k + 1
    if raw_hook is not None:
        raw = raw_hook(raw)
    comp = zlib.compress(raw)
    cut = np.linspace(0, len(comp), idat_parts + 1).astype(int)
    out = pio.PNG_SIGNATURE + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if ctype == 3:
        out += _chunk(b"PLTE", palette)
    for name, body in extra:
        out += _chunk(name, body)
    for i in range(idat_parts):
        out += _chunk(b"IDAT", comp[cut[i]:cut[i + 1]])
    return out + _chunk(b"IEND", b"")


def _same_as_pillow(path):
    got = pio.imread(str(path), dtype="uint8")
    ref = np.asarray(Image.open(path))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    return got


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "mixed", "mixed-0-2", "pillow"])
@pytest.mark.parametrize("ctype", sorted(TYPES))
def test_decode_equals_pillow(tmp_path, ctype, filt):
    rng = np.random.default_rng(ctype * 10 + (filt if isinstance(filt, int) else 7))
    arr = _pixels(rng, ctype)
    path = tmp_path / "im.png"
    if filt == "pillow":  # Pillow's own choice of filters (adaptive)
        im = Image.fromarray(arr, TYPES[ctype][1])
        if ctype == 3:
            im.putpalette(PALETTE)
        im.save(path)
    elif filt in ("mixed", "mixed-0-2"):  # a filter a row, three IDATs, ancillary chunks
        extra = [(b"tEXt", b"Comment\x00made by a test"), (b"gAMA", struct.pack(">I", 45455))]
        if ctype == 3:
            extra.append((b"tRNS", bytes(range(0, 200, 5))))
        # None, Sub and Up only: the codec's row-at-a-time path
        types = 3 if filt == "mixed-0-2" else 5
        path.write_bytes(_png(arr, ctype, rng.integers(0, types, arr.shape[0]), 3, extra))
    else:
        path.write_bytes(_png(arr, ctype, [filt] * arr.shape[0]))
    got = _same_as_pillow(path)
    np.testing.assert_array_equal(got, arr)


@pytest.mark.parametrize("name", ["artifacts/round2/synth_view00.png",
                                  "artifacts/round1/castle_step1-keypoints.png",
                                  "artifacts/round1/castle_step2-matches.png"])
def test_repository_pngs(name):
    data = (ROOT / name).read_bytes()
    assert pio._read_png(data) is not None
    _same_as_pillow(ROOT / name)


@pytest.mark.parametrize("shape", [(61, 47), (33, 70, 3), (1, 1), (1, 9, 3), (29, 31, 2),
                                   (17, 40, 4), (1, 1, 4)])
def test_writer_round_trip(tmp_path, shape):
    arr = np.random.default_rng(len(shape)).integers(0, 256, shape, dtype=np.uint8)
    path = tmp_path / "w.png"
    pio.imsave(str(path), arr)
    ref = np.asarray(Image.open(path))
    assert ref.dtype == np.uint8 and ref.shape == arr.shape
    np.testing.assert_array_equal(ref, arr)
    np.testing.assert_array_equal(_same_as_pillow(path), arr)


def test_writer_refuses_other_arrays(tmp_path):
    for bad in (np.zeros((4, 4), np.float32), np.zeros((4, 4, 5), np.uint8),
                np.zeros((2, 2, 2, 2), np.uint8)):
        with pytest.raises(ValueError):
            pio.imsave(str(tmp_path / "x.png"), bad)


@pytest.mark.parametrize("variant", ["16-bit", "interlaced", "progressive-jpeg"])
def test_other_variants_go_to_pillow(tmp_path, monkeypatch, variant):
    """16-bit and interlaced PNG, which went to Pillow, decode in the
    codec with Pillow unreachable; a progressive JPEG of 4 components
    (CMYK) still goes to Pillow."""
    from spectavi_tpu_torch.pipeline.jpeg import read_jpeg
    from test_torch_jpeg import cmyk_jpeg

    rng = np.random.default_rng(3)
    arr = rng.integers(0, 256, (21, 30), dtype=np.uint8)
    path = tmp_path / ("im.jpg" if variant == "progressive-jpeg" else "im.png")
    if variant == "16-bit":
        Image.fromarray(arr.astype(np.uint16) * 257).save(path)
    elif variant == "interlaced":
        path.write_bytes(_png(arr, 0, [0], interlace=1))
    else:
        path.write_bytes(cmyk_jpeg(arr, quality=90, progressive=True))
    if variant == "progressive-jpeg":
        assert read_jpeg(path.read_bytes()) is None
        got = _same_as_pillow(path)
    else:
        def no_pillow():
            raise AssertionError("the codec handed a PNG to Pillow")

        monkeypatch.setattr(pio, "_pillow", no_pillow)
        pio._decode.cache_clear()
        assert pio._read_png(path.read_bytes()) is not None
        got = _same_as_pillow(path)
        np.testing.assert_array_equal(got.astype(np.int64) // (257 if variant == "16-bit" else 1),
                                      arr)
    assert got.dtype == (np.uint16 if variant == "16-bit" else np.uint8)


def _corrupt(data, how):
    if how == "crc":
        return data[:-5] + bytes([data[-5] ^ 1]) + data[-4:]  # IEND's CRC
    if how == "truncated":
        return data[:len(data) // 2]
    if how == "no-idat":
        i = data.index(b"IDAT") - 4
        n = struct.unpack(">I", data[i:i + 4])[0]
        return data[:i] + data[i + 12 + n:]
    if how == "filter-type":
        raw = b"\x07" + b"\x00" * 4
        return (pio.PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 1, 8, 0, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))
    if how == "short-data":
        return (pio.PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 2, 8, 0, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(b"\x00" * 5)) + _chunk(b"IEND", b""))
    arr = np.random.default_rng(6).integers(0, 2, (9, 11), dtype=np.uint8)
    if how == "bad-depth":  # RGB at 4 bits: IHDR's table has no such pair
        i = data.index(b"IHDR") + 4
        ihdr = data[i:i + 8] + bytes([4, 2]) + data[i + 10:i + 13]
        return data[:i - 8] + _chunk(b"IHDR", ihdr) + data[i + 17:]
    if how == "inflate":  # image data that is not a zlib stream, its CRC intact
        i = data.index(b"IDAT") - 4
        n = struct.unpack(">I", data[i:i + 4])[0]
        return data[:i] + _chunk(b"IDAT", bytes(n)) + data[i + 12 + n:]
    if how == "adam7-short":
        return _png(arr * 255, 0, [4], interlace=1, raw_hook=lambda raw: raw[:-1])
    if how == "sub-byte-row-length":
        # 1-bit rows written one byte a sample, as if they were 8-bit
        data = _png(arr, 0, [1])
        i = data.index(b"IHDR") + 4
        ihdr = data[i:i + 8] + bytes([1]) + data[i + 9:i + 13]
        return data[:i - 8] + _chunk(b"IHDR", ihdr) + data[i + 17:]
    raise ValueError(how)


@pytest.mark.parametrize("how", ["crc", "truncated", "no-idat", "filter-type", "short-data",
                                 "bad-depth", "inflate", "adam7-short",
                                 "sub-byte-row-length"])
def test_malformed_png_raises(tmp_path, how):
    arr = np.random.default_rng(5).integers(0, 256, (9, 11), dtype=np.uint8)
    path = tmp_path / "bad.png"
    path.write_bytes(_corrupt(_png(arr, 0, [4] * 9), how))
    with pytest.raises(ValueError):
        pio.imread(str(path), dtype="uint8")


def _run_blocked(code, blocked=("PIL",), timeout=240):
    """Run ``code`` in a fresh interpreter in which importing any of
    ``blocked`` raises ImportError."""
    pre = "import sys\n" + "".join(f"sys.modules[{m!r}] = None\n" for m in blocked)
    path = os.pathsep.join(p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p)
    env = dict(os.environ, PYTHONPATH=path)
    return subprocess.run([sys.executable, "-c", pre + code], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=str(ROOT))


def _cli(module, argv):
    return (f"import runpy\nsys.argv = {[module] + list(argv)!r}\n"
            f"runpy.run_module({module!r}, run_name='__main__')\n")


@pytest.fixture(scope="module")
def views(tmp_path_factory):
    """The 3 rendered 120x160 views of ``tests/test_sfm_pipeline.py``
    (written by Pillow) and their K file."""
    from test_sfm_pipeline import _tiny_dataset

    tmp = tmp_path_factory.mktemp("views")
    paths, kfile, _ = _tiny_dataset(tmp, np.random.default_rng(0xDEADBEEF))
    return tmp, paths, kfile


@pytest.fixture(scope="module")
def depth_views(views):
    """The views as 16-bit gray PNG (Pillow's encoder, a seeded dither in
    the low byte) and as 8-bit Adam7 PNG (``_png``, every filter type)."""
    import chip_smoke

    tmp, paths, kfile = views
    out = {"16-bit": [], "adam7": []}
    for i, p in enumerate(paths):
        u8 = np.asarray(Image.open(p))
        out["16-bit"].append(str(tmp / f"g16-{i}.png"))
        Image.fromarray(chip_smoke.to_depth(np, u8 / 255.0, 16, 40 + i)).save(out["16-bit"][-1])
        out["adam7"].append(str(tmp / f"adam7-{i}.png"))
        (tmp / f"adam7-{i}.png").write_bytes(_png(u8, 0, [0, 1, 2, 3, 4], interlace=1))
    assert Image.open(out["16-bit"][0]).mode == "I;16"
    return out


def test_imread_without_pillow(views, depth_views, tmp_path):
    from test_torch_jpeg import cmyk_jpeg

    _, paths, _ = views
    jpg, progressive = tmp_path / "im.jpg", tmp_path / "progressive.jpg"
    Image.fromarray(np.full((8, 12), 77, np.uint8)).save(jpg)
    # a progressive file of 4 components (CMYK) goes to Pillow
    progressive.write_bytes(cmyk_jpeg(np.zeros((8, 8), np.uint8), progressive=True))
    pngs = [depth_views["16-bit"][0], depth_views["adam7"][0]]
    code = (
        "import numpy as np\n"
        "from chip_smoke import png_digest\n"
        "from spectavi_tpu_torch.pipeline.io import imread\n"
        f"print(imread({paths[0]!r}, dtype='uint8').shape)\n"
        f"print('baseline', imread({str(jpg)!r}, dtype='uint8').tolist())\n"
        f"for p in {pngs!r}:\n"
        "    print('png', png_digest(imread(p, dtype='uint8')))\n"
        "try:\n"
        f"    imread({str(progressive)!r})\n"
        "except ImportError as e:\n"
        "    print('ImportError:', e)\n")
    out = _run_blocked(code)
    assert out.returncode == 0, out.stderr
    assert "(120, 160)" in out.stdout
    assert f"baseline {np.asarray(Image.open(jpg)).tolist()}" in out.stdout
    from chip_smoke import png_digest

    for p in pngs:
        assert f"png {png_digest(np.asarray(Image.open(p)))}" in out.stdout
    assert "ImportError:" in out.stdout and "Pillow" in out.stdout


def _outputs(out, names):
    """The bytes of the files a run wrote, and its metrics without the
    timings and rates."""
    import json

    files = {n: (out / n).read_bytes() for n in names}
    m = json.loads((out / "metrics.json").read_text())
    return files, {k: v for k, v in m.items()
                   if not k.endswith(("_seconds", "_per_second")) and k != "images"}


def _threads(code):
    """``code`` run with the torch threads this process uses."""
    return "import torch\ntorch.set_num_threads(2)\n" + code


def test_ex01_without_pillow(views, depth_views, tmp_path):
    """ex01 from the 8-bit, the 16-bit and the Adam7 pair with Pillow
    blocked; the 16-bit and Adam7 runs write what the same runs with
    Pillow present write."""
    import torch

    from spectavi_tpu_torch.pipeline import ex01

    _, paths, kfile = views
    pairs = {"8-bit": paths[:2], "16-bit": depth_views["16-bit"][:2],
             "adam7": depth_views["adam7"][:2]}
    argv = lambda name, out: [*pairs[name], kfile, "--device", "cpu", "--outdir", str(out),
                              "--reproj", "3e-3"]
    res = _run_blocked(_threads("".join(
        _cli("spectavi_tpu_torch.pipeline.ex01", argv(name, tmp_path / name)) for name in pairs)))
    assert res.returncode == 0, res.stderr[-3000:]
    for name in pairs:
        out = tmp_path / name
        for n in ("sparse_inliers.ply", "metrics.json"):
            assert (out / n).stat().st_size > 0
        stems = [os.path.basename(p) for p in pairs[name]]
        for n in stems:
            assert np.asarray(Image.open(out / f"rect-{n}")).dtype == np.uint8
        if name != "8-bit":
            torch.set_num_threads(2)
            ex01.main(argv(name, tmp_path / f"{name}-pillow"))
            names = ["sparse_inliers.ply"] + [f"rect-{n}" for n in stems]
            assert _outputs(out, names) == _outputs(tmp_path / f"{name}-pillow", names)


def test_ex02_without_pillow(views, depth_views, tmp_path):
    """ex02 from the 8-bit, the 16-bit and the Adam7 views with Pillow
    blocked; the 16-bit and Adam7 runs write what the same runs with
    Pillow present write."""
    import torch

    from spectavi_tpu_torch.pipeline import ex02

    _, paths, kfile = views
    sets = {"8-bit": paths, "16-bit": depth_views["16-bit"], "adam7": depth_views["adam7"]}
    argv = lambda name, out: [*sets[name], kfile, "--device", "cpu", "--outdir", str(out),
                              "--ba_iters", "3"]
    res = _run_blocked(_threads("".join(
        _cli("spectavi_tpu_torch.pipeline.ex02", argv(name, tmp_path / name)) for name in sets)))
    assert res.returncode == 0, res.stderr[-3000:]
    names = ["sparse_cloud.ply", "poses.txt"]
    for name in sets:
        for n in names + ["metrics.json"]:
            assert (tmp_path / name / n).stat().st_size > 0
        if name != "8-bit":
            torch.set_num_threads(2)
            ex02.main(argv(name, tmp_path / f"{name}-pillow"))
            assert _outputs(tmp_path / name, names) == _outputs(tmp_path / f"{name}-pillow",
                                                                names)


def test_plots_without_matplotlib_fail_before_sift(views, tmp_path):
    _, paths, kfile = views
    cli = _cli("spectavi_tpu_torch.pipeline.ex01",
               [paths[0], paths[1], kfile, "--device", "cpu", "--outdir", str(tmp_path / "p"),
                "--plots"])
    code = ("try:\n" + "".join("    " + line + "\n" for line in cli.splitlines())
            + "except ImportError as e:\n    print('ImportError:', e)\n")
    res = _run_blocked(code, blocked=("PIL", "matplotlib"))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "ImportError:" in res.stdout and "matplotlib" in res.stdout
    assert "step1-computation" not in res.stdout


@pytest.mark.parametrize("name", ["write_ply", "read_ply", "read_txt_matrix", "write_metrics"])
def test_io_helpers_vs_jax(tmp_path, name):
    from spectavi_tpu.pipeline import io as jio

    rng = np.random.default_rng(9)
    pts = np.hstack([rng.standard_normal((25, 3)), np.ones((25, 1))])
    rgb = rng.integers(0, 256, (25, 3)).astype(np.uint8)
    if name in ("write_ply", "read_ply"):
        for color in (None, rgb):
            pio.write_ply(str(tmp_path / "t.ply"), pts, rgb=color)
            jio.write_ply(str(tmp_path / "j.ply"), pts, rgb=color)
            assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
            got, ref = pio.read_ply(str(tmp_path / "j.ply")), jio.read_ply(str(tmp_path / "t.ply"))
            np.testing.assert_array_equal(got, ref)
            np.testing.assert_allclose(got, pts[:, :3], atol=5e-7)
    elif name == "read_txt_matrix":
        (tmp_path / "m.txt").write_text("# K\n1 0 2.5\n\n0 1 -3e-2\n0 0 1\n")
        for header in (True, False):
            if not header:
                (tmp_path / "m.txt").write_text("1 0 2.5\n0 1 -3e-2\n")
            got = pio.read_txt_matrix(str(tmp_path / "m.txt"), header=header)
            ref = jio.read_txt_matrix(str(tmp_path / "m.txt"), header=header)
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)
    else:
        m = {"b": [1, 2], "a": np.float32(0.5), "s": "x", "f": 1.25}
        pio.write_metrics(str(tmp_path / "t.json"), m)
        jio.write_metrics(str(tmp_path / "j.json"), m)
        assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
