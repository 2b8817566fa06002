"""The port's entry points as users run them, from image files, against
the JAX package's on the CPU.

* ex01 (``spectavi_tpu_torch.pipeline.ex01.main``) against
  ``spectavi_tpu.pipeline.ex01.main`` on the rendered 240x320 pair (the
  renderer of ``tests/test_sfm_pipeline.py``), exact L1 matching and a
  loose reprojection threshold:
  - a cold run writes the four outputs and ``cache.npz``; its
    ``metrics.json`` has JAX's keys and its match count is JAX's within
    1% (SIFT agrees to float tolerance, ``test_torch_sift.py``);
  - a second run with ``--cache`` resumes from that file and writes the
    same cloud, rectified images and inliers;
  - given JAX's ``cache.npz`` and JAX's RANSAC draws (torch cannot
    reproduce JAX's threefry, so the port's sampler is handed JAX's
    tables), its sparse cloud is JAX's within ``tests/test_mvg.py``'s
    tolerances and its ``rect-*`` files decode to JAX's pixels (JAX
    writes them with Pillow, the port with its own codec).
* ``run_sfm(pairs="exhaustive", init="chain", loss="linear")`` against
  JAX's on the 3 rendered 120x160 views: keypoints within 1%, matches
  within 2% a pair, tracks within 3%, both trajectories within 10% of
  the span of the truth and within 1% of each other.
* ex02 with ``--pairs exhaustive`` against
  ``examples/ex02_multiview_sfm.py``'s ``main`` on the same views: the
  same files, ``metrics.json`` keys and pairs, and trajectories (from
  ``poses.txt``) within 1% of the span of each other.
"""

import importlib
import json
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from spectavi_tpu.pipeline import ex01 as jax_ex01
from spectavi_tpu_torch.pipeline import ex01, ex02
from spectavi_tpu_torch.pipeline.io import imread, read_ply
from spectavi_tpu_torch.sfm import ate_rmse, camera_centers
from test_torch_ransac import hand_jax_draws

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# rendered keypoints are ~pixel-accurate and exact L1 matching keeps a
# few mismatches: at 1e-2 every match is an inlier on both sides, so the
# two sides fit the same set
EX01_ARGS = ["--matching_method", "bruteforce", "--reproj", "1e-2", "--cache", "--seed", "0"]
RANSAC = {"reprojection_error_allowed": 3e-3}
OUTPUTS = ("sparse_inliers.ply", "rect-v0.png", "rect-v1.png", "metrics.json")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The 240x320 pair and K, and JAX's cold ex01 run on them."""
    from test_sfm_pipeline import _tiny_dataset

    tmp = tmp_path_factory.mktemp("pair")
    paths, kfile, _ = _tiny_dataset(tmp, np.random.default_rng(0xDEADBEEF), nviews=2,
                                    H=240, W=320)
    jax_ex01.main([*paths, kfile, "--outdir", str(tmp / "jax"), *EX01_ARGS])
    return tmp, paths, kfile


def _metrics(d):
    with open(os.path.join(d, "metrics.json")) as f:
        return json.load(f)


def _outputs(d):
    """What an ex01 run wrote: the cloud, the rectified pixels, the
    metrics without timings."""
    m = {k: v for k, v in _metrics(d).items() if not k.endswith("_seconds")}
    rect = [imread(os.path.join(d, n), dtype="uint8") for n in OUTPUTS[1:3]]
    return read_ply(os.path.join(d, OUTPUTS[0])), rect, m


def test_ex01_cold_then_resumed_vs_jax(pair):
    tmp, paths, kfile = pair
    out = str(tmp / "port")
    ex01.main([*paths, kfile, "--outdir", out, "--device", "cpu", *EX01_ARGS])
    for name in OUTPUTS + ("cache.npz",):
        assert os.path.getsize(os.path.join(out, name)) > 0
    mt, mj = _metrics(out), _metrics(tmp / "jax")
    assert set(mt) == set(mj)
    assert mt["matching_method"] == mj["matching_method"] == "bruteforce"
    assert mj["n_matches"] >= 100
    assert abs(mt["n_matches"] - mj["n_matches"]) <= 0.01 * mj["n_matches"]
    assert mt["ransac_success"] and mt["consensus"] == mj["consensus"] == 1.0
    cold = _outputs(out)
    # --cache: the second run takes the matches from cache.npz
    ex01.main([*paths, kfile, "--outdir", out, "--device", "cpu", *EX01_ARGS])
    warm = _outputs(out)
    assert warm[2].pop("match_cache_hit") is True
    for k in ("keypoints", "fused_frontend"):
        cold[2].pop(k)
    assert warm[2] == cold[2]
    np.testing.assert_array_equal(warm[0], cold[0])
    for a, b in zip(warm[1], cold[1]):
        np.testing.assert_array_equal(a, b)


def _ply_colors(path):
    """The vertex colours of an ASCII PLY that ``write_ply`` wrote."""
    with open(path) as f:
        lines = f.read().splitlines()
    body = lines[lines.index("end_header") + 1:]
    return np.asarray([[int(v) for v in line.split()[3:6]] for line in body])


def _ex01_on_jax_cache_vs_jax(paths, kfile, jdir, out, monkeypatch):
    """The port's ex01 given JAX's ``cache.npz`` and JAX's RANSAC draws
    against JAX's run in ``jdir``: the cloud within test_mvg.py's
    tolerances, its colours exact, the ``rect-*`` pixels JAX's."""
    out.mkdir()
    shutil.copy(jdir / "cache.npz", out / "cache.npz")
    hand_jax_draws(monkeypatch, 0)
    ex01.main([*paths, kfile, "--outdir", str(out), "--device", "cpu", *EX01_ARGS])
    names = [os.path.basename(p).split(".")[0] for p in paths]
    rect = [[imread(os.path.join(d, f"rect-{n}.png"), dtype="uint8") for n in names]
            for d in (out, jdir)]
    mt, mj = _metrics(out), _metrics(jdir)
    pt, pj = (read_ply(os.path.join(d, OUTPUTS[0])) for d in (out, jdir))
    assert mt["match_cache_hit"] and mt["n_inliers"] == mj["n_inliers"] == pj.shape[0]
    # test_mvg.py's triangulation tolerances
    np.testing.assert_allclose(pt, pj, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(*(_ply_colors(os.path.join(d, OUTPUTS[0])) for d in (out, jdir)))
    H, W = 240, 320
    for i, (name, a, b) in enumerate(zip(names, *rect)):
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
        it, ij = (np.fromfile(os.path.join(d, f"rect-idx-{name}.bin"), np.int32).reshape(a.shape[:2])
                  for d in (out, jdir))
        # the reference samples column 0 of the second image at source
        # rows that are integers in exact arithmetic, so a one-ulp
        # difference in the camera moves a sample there by one row (or
        # across the image's top or bottom edge, to index -1)
        moved = it != ij
        if i == 1:
            assert not moved[:, 1:].any()
            both = moved & (it >= 0) & (ij >= 0)
            assert (np.abs(it - ij)[both] == W).all() and (it[both] % W == 0).all()
            # one side off the image: the other samples its top or bottom row
            for a_idx, b_idx in ((it, ij), (ij, it)):
                edge = b_idx[moved & (a_idx == -1)]
                assert ((edge % W == 0) & np.isin(edge // W, (0, H - 1))).all()
        else:
            assert not moved.any()
        np.testing.assert_array_equal(a[~moved], b[~moved])
    return rect


def test_ex01_on_jax_matches_and_draws_vs_jax(pair, monkeypatch):
    tmp, paths, kfile = pair
    _ex01_on_jax_cache_vs_jax(paths, kfile, tmp / "jax", tmp / "port_on_jax_cache", monkeypatch)


def test_ex01_rgba_vs_jax(pair, monkeypatch):
    """The pair as RGBA PNGs (Pillow's encoder, colour type 6): the port
    rectifies and writes all four channels, as JAX does with Pillow."""
    from PIL import Image

    tmp, paths, kfile = pair
    rgba = []
    for p in paths:
        g = np.asarray(Image.open(p)).astype(np.int32)
        im = np.stack([g, 3 * g // 4 + 32, g // 2 + 100, 255 - g // 8], axis=-1).astype(np.uint8)
        rgba.append(str(tmp / ("c" + os.path.basename(p))))
        Image.fromarray(im, "RGBA").save(rgba[-1])
    assert Image.open(rgba[0]).mode == "RGBA"
    jax_ex01.main([*rgba, kfile, "--outdir", str(tmp / "jax_rgba"), *EX01_ARGS])
    rect = _ex01_on_jax_cache_vs_jax(rgba, kfile, tmp / "jax_rgba", tmp / "port_rgba",
                                     monkeypatch)
    assert all(a.ndim == 3 and a.shape[2] == 4 for a in rect[0])
    for name, a in zip(("rect-cv0.png", "rect-cv1.png"), rect[0]):
        # the port's files read back by Pillow: RGBA, the same pixels
        im = Image.open(tmp / "port_rgba" / name)
        assert im.mode == "RGBA"
        np.testing.assert_array_equal(np.asarray(im), a)
    assert len(np.unique(_ply_colors(tmp / "port_rgba" / OUTPUTS[0]), axis=0)) > 10


@pytest.fixture(scope="module")
def views(tmp_path_factory):
    from test_sfm_pipeline import _tiny_dataset

    tmp = tmp_path_factory.mktemp("views")
    paths, kfile, gt_C = _tiny_dataset(tmp, np.random.default_rng(0xDEADBEEF))
    return tmp, paths, kfile, gt_C


def _same_reconstruction(m, mj, cams, cams_j, gt_C):
    for a, b in zip(m["keypoints_per_view"], mj["keypoints_per_view"]):
        assert abs(a - b) <= 0.01 * b
    assert [p["pair"] for p in m["pairs"]] == [list(p["pair"]) for p in mj["pairs"]]
    for p, pj in zip(m["pairs"], mj["pairs"]):
        assert abs(p["matches"] - pj["matches"]) <= 0.02 * pj["matches"]
    assert abs(m["n_tracks"] - mj["n_tracks"]) <= 0.03 * mj["n_tracks"]
    assert m["ba_cost_final"] <= m["ba_cost_initial"]
    span = np.ptp(gt_C, axis=0).max()
    est, est_j = camera_centers(cams), camera_centers(cams_j)
    assert ate_rmse(est, gt_C) < 0.10 * span and ate_rmse(est_j, gt_C) < 0.10 * span
    assert ate_rmse(est, est_j) < 0.01 * span


def test_run_sfm_exhaustive_chain_linear_vs_jax(views):
    from spectavi_tpu.pipeline.sfm import run_sfm as jax_run_sfm
    from spectavi_tpu_torch.pipeline.sfm import run_sfm

    _, paths, kfile, gt_C = views
    kw = dict(pairs="exhaustive", init="chain", loss="linear", quiet=True, ransac_options=RANSAC)
    ref = jax_run_sfm(paths, kfile, key=jax.random.PRNGKey(0), **kw)
    res = run_sfm(paths, kfile, device="cpu", **kw)
    m, mj = res["metrics"], ref["metrics"]
    assert len(m["pairs"]) == 3 and m["init_used"] == mj["init_used"] == "chain"
    assert all(p["success"] for p in m["pairs"] + mj["pairs"])
    assert set(mj) <= set(m)
    _same_reconstruction(m, mj, res["cams"], ref["cams"], gt_C)


def test_ex02_exhaustive_vs_jax(views):
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        jax_ex02 = importlib.import_module("ex02_multiview_sfm")
    finally:
        sys.path.remove(os.path.join(ROOT, "examples"))
    tmp, paths, kfile, gt_C = views
    out_t, out_j = str(tmp / "ex02_port"), str(tmp / "ex02_jax")
    jax_ex02.main([*paths, kfile, "--outdir", out_j, "--pairs", "exhaustive"])
    ex02.main([*paths, kfile, "--outdir", out_t, "--pairs", "exhaustive", "--device", "cpu"])
    assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j))
    m, mj = _metrics(out_t), _metrics(out_j)
    assert set(mj) <= set(m) and len(m["pairs"]) == 3
    cams, cams_j = (np.loadtxt(os.path.join(d, "poses.txt")) for d in (out_t, out_j))
    _same_reconstruction(m, mj, cams, cams_j, gt_C)
    assert read_ply(os.path.join(out_t, "sparse_cloud.ply")).shape[0] == m["n_tracks"]
