"""The port's JPEG codec (``csrc/jpeg_host.cpp`` through
``spectavi_tpu_torch.pipeline.jpeg`` and ``pipeline.io``) against Pillow,
and the pipelines from JPEG files against the JAX package.

* Decode: every element equal, with dtype and shape, to
  ``np.asarray(Image.open(f))`` for gray and RGB at 4:4:4, 4:2:2 and
  4:2:0, quality 50, 75 and 95, sizes 1x1 to 599x800; with Huffman
  tables optimised and with restart markers; under libjpeg's colour
  space rules (JFIF, Adobe transform 0, component ids); a file without
  DHT (libjpeg-turbo supplies the Annex K tables); the repository's
  ``castle_rect-01.jpg`` (digest pinned); and a bounded ``hypothesis``
  search over sizes, content and settings.
* Encode: the file is byte-identical to Pillow's ``Image.save`` (gray
  and RGB, odd and even sizes, quality 75 through ``imsave`` and 95).
* Variants the codec leaves to Pillow go to it: CMYK, baseline and
  progressive (4 components); with Pillow blocked
  (``sys.modules["PIL"] = None``, in a subprocess) they raise an
  ``ImportError`` that names Pillow, while baseline files are read and
  written (progressive files are ``test_torch_jpeg_progressive.py``'s
  and ``test_torch_jpeg_smoothing.py``'s).  Malformed files raise
  ``ValueError`` in a subprocess that exits cleanly.  A failed build of
  the codec raises, and the file is not handed to Pillow.
* From the 3 rendered 120x160 views saved as RGB JPEG by Pillow: the
  decoded arrays are JAX's exactly; ex01 and ex02 run as CLIs with
  Pillow blocked; given JAX's matches and RANSAC draws, the port's ex01
  (Pillow blocked) has JAX's inliers, essential matrix, cloud and
  colours, and its ``rect-*.jpg`` are Pillow's files of rectified pixels
  that are JAX's under ``test_torch_entry_points.py``'s column-0 rule;
  SIFT agrees with JAX's under ``test_torch_sift.py``'s rule, and
  ``run_sfm``, given JAX's RANSAC draws, under
  ``test_torch_entry_points.py``'s.
"""

import hashlib
import io
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from spectavi_tpu_torch.ops import _build
from spectavi_tpu_torch.pipeline import io as pio
from spectavi_tpu_torch.pipeline.jpeg import read_jpeg, write_jpeg
from test_torch_png import _cli, _run_blocked

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CASTLE = ROOT / "artifacts" / "round1" / "castle_rect-01.jpg"
# sha256 of np.asarray(Image.open(CASTLE)).tobytes(), (599, 800, 3) uint8,
# with Pillow 12.1.0 on libjpeg-turbo (chip_smoke.py pins the same digest)
CASTLE_SHA256 = "ecc31d49fbaac7b7fda34ac6f9a64000bf6d22ff86320b5e1d842e5125be59c5"
SIZES = [(1, 1), (7, 13), (45, 67), (64, 64), (97, 131), (599, 800)]
SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}


def _pixels(rng, h, w, channels, noise=9):
    """A smooth image with noise, as uint8 ``(h, w)`` or ``(h, w, 3)``."""
    x = np.cumsum(rng.integers(-noise, noise + 1, (h, w, channels)), axis=1) + np.cumsum(
        rng.integers(-noise, noise + 1, (h, 1, channels)), axis=0)
    x = ((x - x.min()) % 256).astype(np.uint8)
    return x[..., 0] if channels == 1 else x


def _pillow_jpeg(arr, **kw):
    f = io.BytesIO()
    Image.fromarray(arr).save(f, format="JPEG", **kw)
    return f.getvalue()


def _pillow_file(arr, name):
    """The file Pillow writes for ``arr`` at its defaults under ``name``'s
    extension."""
    f = io.BytesIO()
    Image.fromarray(arr).save(f, format=Image.registered_extensions()[os.path.splitext(name)[1]])
    return f.getvalue()


def _same_as_pillow(data):
    got = read_jpeg(data)
    ref = np.asarray(Image.open(io.BytesIO(data)))
    assert got is not None
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    return got


def _segments(data):
    """``(marker, start, end)`` of each marker segment before the first
    SOS, ``end`` one past the segment."""
    pos, out = 2, []
    while True:
        m = data[pos + 1]
        end = pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        out.append((m, pos, end))
        if m == 0xDA:
            return out
        pos = end


def _without(data, markers):
    """``data`` with every segment of the given markers before SOS cut out."""
    keep, last = bytearray(data[:2]), 2
    for m, start, end in _segments(data):
        if m in markers:
            keep += data[last:start]
            last = end
    return bytes(keep + data[last:])


@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("sub", sorted(SUBSAMPLING))
@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_decode_equals_pillow(mode, sub, quality):
    rng = np.random.default_rng(quality + 7 * SUBSAMPLING[sub] + (100 if mode == "RGB" else 0))
    for h, w in SIZES:
        arr = _pixels(rng, h, w, 3 if mode == "RGB" else 1)
        data = _pillow_jpeg(arr, quality=quality, subsampling=SUBSAMPLING[sub])
        got = _same_as_pillow(data)
        assert got.shape == arr.shape


@pytest.mark.parametrize("restart", [0, 1, 7])
@pytest.mark.parametrize("optimize", [False, True])
def test_decode_optimized_and_restarts(optimize, restart):
    rng = np.random.default_rng(restart + 10 * optimize)
    for mode in ("L", "RGB"):
        for sub in (2, 1):
            for h, w in ((45, 67), (97, 131)):
                arr = _pixels(rng, h, w, 3 if mode == "RGB" else 1)
                kw = {"restart_marker_blocks": restart} if restart else {}
                data = _pillow_jpeg(arr, optimize=optimize, subsampling=sub, **kw)
                assert (b"\xff\xdd" in data) == bool(restart)
                _same_as_pillow(data)


@pytest.mark.parametrize("space", ["jfif", "no-jfif", "adobe-rgb", "rgb-ids"])
def test_colour_space_rules(space):
    """libjpeg's rules for a 3-component file: JFIF means YCbCr, and so
    do ids 1, 2, 3 without JFIF or Adobe markers; an Adobe marker with
    transform 0 (Pillow's ``keep_rgb``), or ids 'R', 'G', 'B', mean
    RGB as stored."""
    arr = _pixels(np.random.default_rng(11), 37, 53, 3)
    data = _pillow_jpeg(arr, keep_rgb=space in ("adobe-rgb", "rgb-ids"))
    if space == "no-jfif":
        data = _without(data, {0xE0})
    elif space == "rgb-ids":
        data = _without(data, {0xEE})
    got = _same_as_pillow(data)
    if space in ("adobe-rgb", "rgb-ids"):
        assert 0xE0 not in [m for m, _, _ in _segments(data)]
        # stored as RGB: no colour conversion, so close to the input
        assert np.abs(got.astype(int) - arr).mean() < 4


def test_file_without_dht_gets_annex_k_tables():
    """Motion-JPEG frames carry no DHT: libjpeg-turbo decodes them with
    the Annex K tables, and so does the codec."""
    arr = _pixels(np.random.default_rng(12), 40, 56, 3)
    data = _pillow_jpeg(arr)
    bare = _without(data, {0xC4})
    assert b"\xff\xc4" not in bare[:bare.index(b"\xff\xda")]
    np.testing.assert_array_equal(_same_as_pillow(bare), _same_as_pillow(data))


def test_castle_file(monkeypatch):
    def no_pillow():
        raise AssertionError("a baseline JPEG went to Pillow")

    monkeypatch.setattr(pio, "_pillow", no_pillow)
    pio._decode.cache_clear()
    got = pio.imread(str(CASTLE), dtype="uint8")
    assert got.shape == (599, 800, 3) and got.dtype == np.uint8
    assert hashlib.sha256(got.tobytes()).hexdigest() == CASTLE_SHA256
    np.testing.assert_array_equal(got, np.asarray(Image.open(CASTLE)))


@settings(max_examples=60, deadline=None, derandomize=True)
@given(h=st.integers(1, 70), w=st.integers(1, 70), mode=st.sampled_from(["L", "RGB"]),
       sub=st.sampled_from([0, 1, 2]), quality=st.integers(1, 100),
       content=st.sampled_from(["smooth", "noise", "flat", "edges"]),
       restart=st.integers(0, 3), optimize=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_decode_random_files_equal_pillow(h, w, mode, sub, quality, content, restart, optimize,
                                         seed):
    rng = np.random.default_rng(seed)
    c = 3 if mode == "RGB" else 1
    if content == "smooth":
        arr = _pixels(rng, h, w, c).reshape(h, w, c)
    elif content == "noise":
        arr = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    elif content == "flat":
        arr = np.full((h, w, c), rng.integers(0, 256), np.uint8)
    else:  # saturated edges, which drive the IDCT past its range
        arr = (rng.random((h, w, c)) < 0.5).astype(np.uint8) * 255
    arr = arr[..., 0] if c == 1 else arr
    kw = {"restart_marker_blocks": restart} if restart else {}
    data = _pillow_jpeg(arr, quality=quality, subsampling=sub, optimize=optimize, **kw)
    _same_as_pillow(data)
    # the writer: Pillow's file at Pillow's defaults but the quality
    assert _encode(arr, quality) == _pillow_jpeg(arr, quality=quality)


def _encode(arr, quality):
    """The writer's file of ``arr`` at ``quality``, as bytes."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = pathlib.Path(d) / "w.jpg"
        write_jpeg(str(path), arr, quality=quality)
        return path.read_bytes()


@pytest.mark.parametrize("quality", [None, 95])
@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (8, 8), (45, 67), (64, 64), (97, 131),
                                   (1, 1, 3), (7, 13, 3), (16, 16, 3), (45, 67, 3), (64, 64, 3),
                                   (97, 131, 3), (599, 800, 3)])
def test_writer_file_equals_pillow(tmp_path, shape, quality):
    """``imsave`` of a ``.jpg`` (quality 75, Pillow's default) and the
    writer at quality 95: Pillow's file, byte for byte."""
    arr = _pixels(np.random.default_rng(len(shape) * 1000 + shape[0]), shape[0], shape[1],
                  shape[2] if len(shape) == 3 else 1)
    path = tmp_path / ("w.JPEG" if quality is None else "w.jpg")
    if quality is None:
        pio.imsave(str(path), arr)
    else:
        write_jpeg(str(path), arr, quality=quality)
    got = path.read_bytes()
    ref = _pillow_jpeg(arr, **({} if quality is None else {"quality": quality}))
    assert got == ref
    np.testing.assert_array_equal(pio.imread(str(path), dtype="uint8"),
                                  np.asarray(Image.open(path)))


def test_writer_refuses_other_arrays(tmp_path):
    for bad in (np.zeros((4, 4), np.float32), np.zeros((4, 4, 4), np.uint8),
                np.zeros((4, 4, 2), np.uint8), np.zeros((2, 2, 2, 3), np.uint8)):
        with pytest.raises(ValueError):
            pio.imsave(str(tmp_path / "x.jpg"), bad)


def cut_after_scan(data, k):
    """``data`` cut after its ``k``-th scan's entropy-coded data, with
    EOI appended: for a progressive file, one whose later scans never
    refine what the first ``k`` coded."""
    pos = 0
    for _ in range(k):
        pos = data.index(b"\xff\xda", pos) + 2
    pos += int.from_bytes(data[pos:pos + 2], "big")
    # the next marker: FF followed by neither a stuffed 00 nor an RSTn
    while not (data[pos] == 0xFF and data[pos + 1] not in (0x00, *range(0xD0, 0xD8))):
        pos += 1
    return data[:pos] + b"\xff\xd9"


def cmyk_jpeg(arr, **kw):
    """Pillow's JPEG of ``arr`` converted to CMYK: 4 components, which
    the codec leaves to Pillow."""
    f = io.BytesIO()
    Image.fromarray(arr).convert("CMYK").save(f, format="JPEG", **kw)
    return f.getvalue()


def _variant(name):
    """CMYK files, baseline and progressive (of a gray and of an RGB
    image): progressive files of 1 or 3 components are the codec's,
    even where their scans leave coefficients unrefined."""
    arr = _pixels(np.random.default_rng(13), 33, 47, 1 if name == "progressive-gray" else 3)
    return cmyk_jpeg(arr, progressive=name != "cmyk")


@pytest.mark.parametrize("name", ["progressive-gray", "progressive-rgb", "cmyk"])
def test_other_variants_go_to_pillow(tmp_path, name):
    data = _variant(name)
    assert read_jpeg(data) is None
    path = tmp_path / "v.jpg"
    path.write_bytes(data)
    ref = np.asarray(Image.open(path))
    got = pio.imread(str(path), dtype="uint8")
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_without_pillow(tmp_path):
    """Baseline files are read and written with Pillow blocked; the
    variants left to Pillow raise an ImportError that names it."""
    rng = np.random.default_rng(14)
    gray, rgb = _pixels(rng, 29, 35, 1), _pixels(rng, 29, 35, 3)
    for name, arr in (("gray", gray), ("rgb", rgb)):
        (tmp_path / f"{name}.jpg").write_bytes(_pillow_jpeg(arr))
        np.save(tmp_path / f"{name}.npy", arr)
    for name in ("progressive-rgb", "cmyk"):
        (tmp_path / f"{name}.jpg").write_bytes(_variant(name))
    code = (
        "import numpy as np\n"
        "from spectavi_tpu_torch.pipeline.io import imread, imsave\n"
        f"d = {str(tmp_path)!r}\n"
        "for n in ('gray', 'rgb'):\n"
        "    im = imread(f'{d}/{n}.jpg', dtype='uint8')\n"
        "    np.save(f'{d}/{n}_read.npy', im)\n"
        "    imsave(f'{d}/{n}_written.jpg', np.load(f'{d}/{n}.npy'))\n"
        "for n in ('progressive-rgb', 'cmyk'):\n"
        "    try:\n"
        "        imread(f'{d}/{n}.jpg')\n"
        "    except ImportError as e:\n"
        "        print(n, 'ImportError:', e)\n")
    out = _run_blocked(code)
    assert out.returncode == 0, out.stderr
    for name, arr in (("gray", gray), ("rgb", rgb)):
        ref = np.asarray(Image.open(tmp_path / f"{name}.jpg"))
        np.testing.assert_array_equal(np.load(tmp_path / f"{name}_read.npy"), ref)
        assert (tmp_path / f"{name}_written.jpg").read_bytes() == _pillow_jpeg(arr)
    lines = out.stdout.splitlines()
    for name in ("progressive-rgb", "cmyk"):
        line = next(x for x in lines if x.startswith(name + " "))
        assert "ImportError:" in line and "Pillow" in line


def _malformed(how):
    """Files that the decoder must refuse with ValueError."""
    rng = np.random.default_rng(15)
    data = _pillow_jpeg(_pixels(rng, 45, 67, 3), restart_marker_blocks=4)
    sos = data.index(b"\xff\xda")
    scan = sos + 14  # first byte of entropy-coded data
    if how == "truncated":
        # everything from the first byte to the last one before EOI
        return [data[:k] for k in range(0, len(data) - 1, 3)] + [data[:-1], data[:-2]]
    if how == "huffman":
        # a run of stuffed FF bytes: sixteen 1 bits, no code in Annex K
        return [data[:scan + 5] + b"\xff\x00" * 4 + data[scan + 13:]]
    if how == "missing-dht":
        # the scan's chroma names Huffman tables 2, which nothing defines
        b = bytearray(data)
        b[sos + 7] = 0x22
        return [bytes(b)]
    if how == "missing-dqt":
        return [_without(data, {0xDB})]
    if how == "no-sos":
        return [data[:sos] + b"\xff\xd9"]
    if how == "sos-before-sof":
        sof = next(s for m, s, e in _segments(data) if m == 0xC0)
        sof_end = next(e for m, s, e in _segments(data) if m == 0xC0)
        # the frame header moved to just before EOI, after the scan
        return [data[:sof] + data[sof_end:-2] + data[sof:sof_end] + data[-2:]]
    if how == "restart-marker":
        k = data.index(b"\xff\xd0", scan)
        return [data[:k + 1] + b"\xd3" + data[k + 2:]]
    raise ValueError(how)


@pytest.mark.parametrize("how", ["truncated", "huffman", "missing-dht", "missing-dqt", "no-sos",
                                 "sos-before-sof", "restart-marker"])
def test_malformed_raises_cleanly(tmp_path, how):
    files = _malformed(how)
    for i, data in enumerate(files):
        (tmp_path / f"{i}.jpg").write_bytes(data)
    code = (
        "from spectavi_tpu_torch.pipeline.jpeg import read_jpeg\n"
        f"for i in range({len(files)}):\n"
        f"    data = open(f'{tmp_path}/{{i}}.jpg', 'rb').read()\n"
        "    try:\n"
        "        read_jpeg(data)\n"
        "        print(i, 'decoded')\n"
        "    except ValueError as e:\n"
        "        print(i, 'ValueError', e)\n")
    out = _run_blocked(code, blocked=())
    # a crash would end the interpreter on a signal: a negative code
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert len(lines) == len(files)
    assert all(" ValueError " in line for line in lines), [x for x in lines if "decoded" in x]


def test_failed_build_raises_and_never_falls_back(tmp_path):
    """A compiler that fails: decoding a baseline JPEG raises with the
    compiler's log (Pillow is there, and is not used), and so does
    writing one."""
    path = tmp_path / "im.jpg"
    path.write_bytes(_pillow_jpeg(_pixels(np.random.default_rng(16), 9, 9, 3)))
    code = (
        "from spectavi_tpu_torch.pipeline.io import imread, imsave\n"
        "import numpy as np\n"
        "for fn in (lambda: imread(" + repr(str(path)) + "),\n"
        "           lambda: imsave(" + repr(str(tmp_path / "w.jpg")) + ", np.zeros((4, 4), np.uint8))):\n"
        "    try:\n"
        "        fn()\n"
        "        print('no error')\n"
        "    except RuntimeError as e:\n"
        "        print('RuntimeError:', str(e).splitlines()[0])\n")
    env = dict(os.environ, CXX=shutil.which("false"),
               SPECTAVI_TORCH_BUILD_DIR=str(tmp_path / "build"),
               PYTHONPATH=os.pathsep.join(p for p in (str(ROOT), os.environ.get("PYTHONPATH"))
                                          if p))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert len(lines) == 2 and all("failed for jpeg_host.cpp" in x for x in lines), lines
    assert not (tmp_path / "w.jpg").exists()


def test_host_source_build_names():
    assert _build._source("jpeg_host").name == "jpeg_host.cpp"
    assert _build._source("jpeg_host").exists()
    assert _build.lib_path("jpeg_host").name.startswith("jpeg_host-")
    assert "jpeg_host" not in _build.KERNELS  # not a CUDA kernel
    assert _build.CXX_FLAGS == ("-O3", "-std=c++17", "-fPIC", "-shared")


# --- the pipelines from JPEG files --------------------------------------


def make_jpeg_views(tmp, **save_kw):
    """The 3 rendered 120x160 views of ``tests/test_sfm_pipeline.py`` as
    RGB JPEG (distinct channels) in ``tmp``, written by Pillow at its
    defaults and ``save_kw``: ``(tmp, paths, K file, camera centres)``."""
    from test_sfm_pipeline import _tiny_dataset

    pngs, kfile, gt_C = _tiny_dataset(tmp, np.random.default_rng(0xDEADBEEF))
    paths = []
    for p in pngs:
        g = np.asarray(Image.open(p)).astype(np.int32)
        rgb = np.stack([g, 3 * g // 4 + 32, g // 2 + 100], axis=-1).astype(np.uint8)
        paths.append(p[:-4] + ".jpg")
        Image.fromarray(rgb).save(paths[-1], **save_kw)
    return tmp, paths, kfile, gt_C


@pytest.fixture(scope="module")
def jpeg_views(tmp_path_factory):
    return make_jpeg_views(tmp_path_factory.mktemp("jpeg_views"))


def _block_pillow(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    pio._decode.cache_clear()


def test_decoded_views_are_jax_arrays(jpeg_views, monkeypatch):
    from spectavi_tpu.pipeline.io import imread as jax_imread

    _, paths, _, _ = jpeg_views
    ref = {(p, k): jax_imread(p, **kw) for p in paths
           for k, kw in (("u8", {"dtype": "uint8"}),
                         ("gray32", {"dtype": "float32", "force_grayscale": True}),
                         ("f64", {}))}
    _block_pillow(monkeypatch)
    for p in paths:
        for k, kw in (("u8", {"dtype": "uint8"}),
                      ("gray32", {"dtype": "float32", "force_grayscale": True}), ("f64", {})):
            got, want = pio.imread(p, **kw), np.asarray(ref[p, k])
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)


def test_clis_without_pillow(jpeg_views, tmp_path):
    clis_without_pillow(jpeg_views, tmp_path)


def clis_without_pillow(jpeg_views, tmp_path):
    """ex01 and ex02 as CLIs from the views, with Pillow blocked."""
    _, paths, kfile, _ = jpeg_views
    # two threads, as in this process: the suite's workers share the cores
    threads = "import torch\ntorch.set_num_threads(2)\n"
    out = tmp_path / "ex01"
    res = _run_blocked(threads + _cli("spectavi_tpu_torch.pipeline.ex01",
                                      [paths[0], paths[1], kfile, "--device", "cpu", "--outdir",
                                       str(out), "--reproj", "3e-3"]))
    assert res.returncode == 0, res.stderr[-3000:]
    for name in ("sparse_inliers.ply", "rect-v0.jpg", "rect-v1.jpg", "metrics.json"):
        assert (out / name).stat().st_size > 0
    for name in ("rect-v0.jpg", "rect-v1.jpg"):
        im = Image.open(out / name)
        assert im.format == "JPEG" and im.mode == "RGB"
    out2 = tmp_path / "ex02"
    res = _run_blocked(threads + _cli("spectavi_tpu_torch.pipeline.ex02",
                                      [*paths, kfile, "--device", "cpu", "--outdir", str(out2),
                                       "--ba_iters", "3"]))
    assert res.returncode == 0, res.stderr[-3000:]
    for name in ("sparse_cloud.ply", "poses.txt", "metrics.json"):
        assert (out2 / name).stat().st_size > 0


def test_ex01_on_jax_matches_and_draws_vs_jax(jpeg_views, monkeypatch):
    ex01_on_jax_matches_and_draws_vs_jax(jpeg_views, monkeypatch)


def ex01_on_jax_matches_and_draws_vs_jax(jpeg_views, monkeypatch):
    """JAX's ``run_two_view`` (Pillow decodes and writes) and the port's
    ex01 (Pillow blocked) given JAX's ``cache.npz`` and RANSAC draws, on
    a pair of RGB files of any size and of any format both write
    (``rect-*`` in the inputs' format)."""
    from spectavi_tpu.pipeline.two_view import run_two_view as jax_run_two_view
    from spectavi_tpu_torch.pipeline import ex01
    from test_torch_entry_points import EX01_ARGS, _ply_colors
    from test_torch_ransac import hand_jax_draws

    tmp, paths, kfile, _ = jpeg_views
    paths = paths[:2]
    jdir, out = tmp / "jax_ex01", tmp / "port_ex01"
    ref = jax_run_two_view(paths, kfile, outdir=str(jdir), matching_method="bruteforce",
                           cache=True, key=jax.random.PRNGKey(0), quiet=True,
                           ransac_options={"reprojection_error_allowed": 1e-2,
                                           "find_best_even_in_failure": True})
    out.mkdir()
    shutil.copy(jdir / "cache.npz", out / "cache.npz")
    hand_jax_draws(monkeypatch, 0)
    with monkeypatch.context() as m:
        _block_pillow(m)
        res = ex01.main([*paths, kfile, "--outdir", str(out), "--device", "cpu", *EX01_ARGS])
    assert res["metrics"]["match_cache_hit"]
    for k in (0, 1):
        np.testing.assert_array_equal(res["matches"][k], ref["matches"][k])
    rt, rj = res["ransac"], ref["ransac"]
    np.testing.assert_array_equal(rt["inlier_idx"], np.asarray(rj["inlier_idx"]))
    assert res["metrics"]["n_inliers"] == ref["metrics"]["n_inliers"] >= 50
    np.testing.assert_allclose(rt["essential"], np.asarray(rj["essential"]), atol=1e-9)
    # test_mvg.py's triangulation tolerances; the colours exact
    ply = [os.path.join(d, "sparse_inliers.ply") for d in (out, jdir)]
    np.testing.assert_allclose(*(pio.read_ply(p) for p in ply), rtol=1e-6, atol=1e-6)
    colors = [_ply_colors(p) for p in ply]
    np.testing.assert_array_equal(*colors)
    assert len(np.unique(colors[0], axis=0)) > 10
    W = pio.imread(paths[1], dtype="uint8").shape[1]
    for i, p in enumerate(paths):
        name = os.path.basename(p)
        # the float rectification of the CPU route, as both writers store it
        a, b = (np.clip(np.asarray(r["rectified"][i]) * 255, 0, 255).astype(np.uint8)
                for r in (res, ref))
        assert a.shape == b.shape and a.ndim == 3 and a.shape[2] == 3
        it, ij = (np.fromfile(os.path.join(d, f"rect-idx-{name[:-4]}.bin"), np.int32)
                  .reshape(a.shape[:2]) for d in (out, jdir))
        # test_torch_entry_points.py's rule: only column-0 samples of the
        # second image move, by one source row
        moved = it != ij
        if i == 1:
            assert not moved[:, 1:].any()
            both = moved & (it >= 0) & (ij >= 0)
            assert (np.abs(it - ij)[both] == W).all() and (it[both] % W == 0).all()
        else:
            assert not moved.any()
        np.testing.assert_array_equal(a[~moved], b[~moved])
        # the files: Pillow's files of each side's pixels, so identical
        # wherever no sample moved
        got, want = ((d / f"rect-{name}").read_bytes() for d in (out, jdir))
        assert got == _pillow_file(a, p) and want == _pillow_file(b, p)
        if not moved.any():
            assert got == want
        assert pio.imread(str(out / f"rect-{name}"), dtype="uint8").shape == a.shape


def test_sift_and_matches_vs_jax(jpeg_views):
    """Step 1 on the JPEG files under test_torch_sift.py's rule, and
    the cold two-view run's match count within 1% of JAX's."""
    from spectavi_tpu.pipeline import two_view as jtv
    from spectavi_tpu_torch.pipeline import two_view as ttv
    from test_torch_sift import _agreement

    _, paths, kfile, _ = jpeg_views
    got = ttv.step1_sift_detect(paths[:2], quiet=True, device="cpu")
    ref = jtv.step1_sift_detect(paths[:2], quiet=True)
    for g, r in zip(got, ref):
        assert abs(len(g) - len(r)) <= 0.01 * len(r)
        assert min(_agreement(r, g)) >= 0.99
    kw = dict(outdir=None, matching_method="bruteforce", quiet=True,
              ransac_options={"reprojection_error_allowed": 1e-2})
    mt = ttv.run_two_view(paths[:2], kfile, device="cpu", **kw)["metrics"]
    mj = jtv.run_two_view(paths[:2], kfile, key=jax.random.PRNGKey(0), **kw)["metrics"]
    assert mj["n_matches"] >= 100
    assert abs(mt["n_matches"] - mj["n_matches"]) <= 0.01 * mj["n_matches"]


def _hand_jax_pair_draws(monkeypatch, seed):
    """Give the port's pair loop the RANSAC tables of JAX's
    ``run_sfm(key=PRNGKey(seed))``: one split of the run's key a pair,
    and within the pair one split a block, as JAX's fitter does."""
    from spectavi_tpu.mvg import ransac as jran
    from spectavi_tpu_torch.mvg import ransac as tran
    from spectavi_tpu_torch.pipeline import sfm as tsfm

    keys = {"run": jax.random.PRNGKey(seed), "pairs": 0}

    def draw(n, trials, point_mask, generator=None):
        keys["pair"], sub = jax.random.split(keys["pair"])
        table = jran._sample_subsets(sub, n, trials, jax.numpy.asarray(point_mask.cpu().numpy()))
        return torch.tensor(np.asarray(table), device=point_mask.device)

    def pair_loop(*a, **k):
        keys["run"], keys["pair"] = jax.random.split(keys["run"])
        keys["pairs"] += 1
        return loop(*a, **k)

    loop = tsfm._match_pair_loop
    monkeypatch.setattr(tran, "sample_subsets", draw)
    monkeypatch.setattr(tsfm, "_match_pair_loop", pair_loop)
    return keys


def test_run_sfm_vs_jax(jpeg_views, monkeypatch):
    run_sfm_vs_jax(jpeg_views, monkeypatch)


def run_sfm_vs_jax(jpeg_views, monkeypatch):
    """Given JAX's RANSAC draws (on the JPEG views the draws alone move
    the track count by up to 6% on either side)."""
    from spectavi_tpu.pipeline.sfm import run_sfm as jax_run_sfm
    from spectavi_tpu_torch.pipeline.sfm import run_sfm
    from test_torch_entry_points import RANSAC, _same_reconstruction

    _, paths, kfile, gt_C = jpeg_views
    kw = dict(pairs="exhaustive", init="chain", loss="linear", quiet=True, ransac_options=RANSAC)
    ref = jax_run_sfm(paths, kfile, key=jax.random.PRNGKey(0), **kw)
    keys = _hand_jax_pair_draws(monkeypatch, 0)
    _block_pillow(monkeypatch)
    res = run_sfm(paths, kfile, device="cpu", **kw)
    m, mj = res["metrics"], ref["metrics"]
    assert keys["pairs"] == 3
    assert m["pair_backend"] == mj.get("pair_backend", "loop") == "loop"
    assert len(m["pairs"]) == 3 and m["init_used"] == mj["init_used"] == "chain"
    assert all(p["success"] for p in m["pairs"] + mj["pairs"])
    _same_reconstruction(m, mj, res["cams"], ref["cams"], gt_C)
