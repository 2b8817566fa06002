"""The port stands alone: ``spectavi_tpu_torch`` and ``chip_smoke.py``
import neither ``jax`` nor ``spectavi_tpu``, and entry points run on
CUDA unless the caller asks for the CPU (without CUDA they raise)."""

import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import spectavi_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "spectavi_tpu_torch")


def _modules():
    return [
        m.name
        for m in pkgutil.walk_packages([PKG], prefix="spectavi_tpu_torch.")
    ]


def test_import_every_module_without_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {['spectavi_tpu_torch'] + _modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'spectavi_tpu.'))"
        " or m == 'spectavi_tpu']\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_ast_scan_finds_no_jax_imports():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for f in files:
        for name in _imported_roots(f):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "spectavi_tpu"), (f, name)


def test_entry_points_raise_without_cuda(monkeypatch):
    from spectavi_tpu_torch.features import sift_filter_batch
    from spectavi_tpu_torch.match import nn_l2k2
    from spectavi_tpu_torch.mvg import ransac_fitter, rectify_pair_quantized
    from spectavi_tpu_torch.pipeline.two_view import run_two_view

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        run_two_view(["a.png", "b.png"], "K.txt", outdir=None)
    with pytest.raises(RuntimeError):
        sift_filter_batch([np.zeros((32, 32), np.float32)])
    with pytest.raises(RuntimeError):
        ransac_fitter(np.zeros((20, 2)), np.zeros((20, 2)))
    with pytest.raises(RuntimeError):
        nn_l2k2(np.zeros((4, 16), np.uint8), np.zeros((4, 16), np.uint8))
    with pytest.raises(RuntimeError):
        rectify_pair_quantized(np.eye(3, 4), np.eye(3, 4), np.zeros((8, 8)), np.zeros((8, 8)))
    with pytest.raises(RuntimeError):
        spectavi_tpu_torch.resolve_device()
    assert spectavi_tpu_torch.resolve_device("cpu").type == "cpu"


_F = np.zeros((40, 16), np.float32)
_B = np.zeros((40, 16), np.uint8)
MATCHER_CALLS = {
    "nn_bruteforce": lambda m: m.nn_bruteforce(_F, _F),
    "nn_bruteforce_mu": lambda m: m.nn_bruteforce(_F, _F, mu=1.0),
    "l1_topk2_xla": lambda m: m.l1_topk2_xla(_B, _B),
    "nn_bruteforcel1k2": lambda m: m.nn_bruteforcel1k2(_B, _B),
    "nn_cascading_hash": lambda m: m.nn_cascading_hash(_F, _F, m=4),
    "nn_cascading_hash_fallback": lambda m: m.nn_cascading_hash(_F, _F),
    "kmedians": lambda m: m.kmedians(None, _F, 3),
    "nn_kmedians": lambda m: m.nn_kmedians(_F, _F, 2),
    "kmeans_cells": lambda m: m.ivf.kmeans_cells(_F, None, 4),
    "probe_cells": lambda m: m.ivf.probe_cells(_F, _F[:4], 2),
    "nn_ivf": lambda m: m.nn_ivf(_F, _F),
    "ann": lambda m: m.ann(_F, _F),
    "ann_hnswlib": lambda m: m.ann_hnswlib(_F, _F),
}


@pytest.mark.parametrize("name", sorted(MATCHER_CALLS))
def test_matchers_raise_without_cuda(monkeypatch, name):
    from spectavi_tpu_torch import match

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MATCHER_CALLS[name](match)


def test_step2_raises_without_cuda(monkeypatch):
    from spectavi_tpu_torch.pipeline.two_view import step2_match_keypoints

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rows = (100 * np.random.default_rng(0).random((40, 132))).astype(np.float32)
    for method in ("auto", "l2-mxu", "bruteforce", "cascading-hash"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            step2_match_keypoints((rows, rows), method, quiet=True)


def test_new_modules_are_walked():
    names = _modules()
    for name in ("match.ann", "match.bruteforce", "match.cascade_hash", "match.ivf",
                 "match.kmedians", "pipeline.viz", "parallel.hosts", "parallel.mesh",
                 "parallel.two_view", "sfm.distributed", "utils", "utils.hostops",
                 "utils.profiling"):
        assert "spectavi_tpu_torch." + name in names


def test_precision_pin():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_kernel_sources_and_build_names():
    from spectavi_tpu_torch.ops import _build

    for name in _build.KERNELS:
        src = _build.CSRC / f"{name}.cu"
        assert src.exists()
        text = src.read_text()
        assert "extern \"C\"" in text and "cudaGetLastError" in text
        # names the Pallas kernel it replaces, or says it replaces none and
        # names the JAX package's function whose work it does
        assert "spectavi_tpu/ops/" in text or (
            "Replaces no TPU kernel" in text and "spectavi_tpu/mvg/" in text)
        # the content hash changes with the source, so a stale library is never loaded
        assert _build.lib_path(name).name.startswith(name + "-")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_chip_smoke_refuses_without_cuda(tmp_path):
    # alone in a directory, and with no CUDA device here: no result line
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    out = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


# sha256 of the small pair's colours and of its grays, each view's bytes in
# turn, as chip_smoke.py rendered them before it took the benchmark's
# renderer (sfmbench/scene.py): the card's gates and the benchmark's cells
# both run on these renders
SMALL_PAIR_SHA256 = {
    "colors": "db259848edbfeaffc03a6892954bd8c963efeaa8a10754d830d2134158339753",
    "grays": "fa37cd11ee55d38726c28211c4b656dba51b821a98d1394ca7c217babfc888e1",
}


def test_chip_smoke_render_is_pinned():
    import hashlib

    import chip_smoke

    grays, colors, _, _ = chip_smoke.render_pair(240, 320, "cpu", chip_smoke.SMALL_TEX)
    for name, views, dtype in (("colors", colors, np.uint8), ("grays", grays, np.float32)):
        assert [(v.dtype, v.shape) for v in views] == [(np.dtype(dtype), (240, 320))] * 2
        digest = hashlib.sha256(b"".join(np.ascontiguousarray(v).tobytes() for v in views))
        assert digest.hexdigest() == SMALL_PAIR_SHA256[name], name
