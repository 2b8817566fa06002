"""Port parity for the slice as a whole: the two-view ex01 pipeline of
``spectavi_tpu_torch`` against ``spectavi_tpu`` on a rendered pair (the
renderer of ``tests/test_sfm_pipeline.py``), both on the CPU.

* SIFT of both views, at the tolerances of ``test_torch_sift.py``.
* ``run_two_view(matching_method="l2-mxu")``: the two sides run the same
  SIFT -> quantize -> exact L2 top-2 -> ratio test front end, then
  RANSAC with their own random streams (torch cannot reproduce JAX's
  threefry), so match counts agree within 1%, consensus within 0.02,
  and the inlier sets overlap with Jaccard >= 0.95; ``metrics.json``
  has the same keys and the rectified outputs the same shapes.
* ``run_two_view_arrays(device="cpu")`` with ``matching_method``
  ``"auto"`` (the cascade hash on the CPU, as in the JAX package),
  ``"cascading-hash"`` and ``"bruteforce"`` against the JAX package's
  run on the same images.  The exact L1 matcher gives the same matches
  on both sides: counts within 1%, consensus within 0.02.  The cascade
  hash draws its hyperplanes from each package's own generator
  (``torch.randn`` against ``jax.random.normal``), so the two sides
  re-rank different candidate sets: counts within 3%, consensus within
  0.04.
* ``rectify_pair_quantized`` given the same cameras: float32 geometry on
  both sides, index maps exact and pixels within 1 LSB.
* ``step12_fused_device`` (SIFT -> on-device quantization -> exact L2
  top-2 -> ratio test) against the JAX one, which runs its XLA route
  here: SIFT agrees to float tolerance (``test_torch_sift.py``), so a
  few keypoints sit on the other side of a quantization or ratio
  boundary; at least 99% of the match rows agree (both image points
  within 0.01 px) and the counts agree within 1%.
"""

import atexit
import functools
import json
import os
import pathlib
import shutil
import tempfile

import jax
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from spectavi_tpu.mvg.rectify import rectify_pair as jax_rectify_pair
from spectavi_tpu.mvg.rectify import rectify_pair_quantized as jax_rectify_pair_quantized
from spectavi_tpu.pipeline.two_view import run_two_view as jax_run_two_view
from spectavi_tpu.pipeline.two_view import step12_fused_device as jax_step12
from spectavi_tpu_torch.mvg import rectify_pair, rectify_pair_quantized
from spectavi_tpu_torch.pipeline.io import imread
from spectavi_tpu_torch.pipeline.two_view import (
    resolve_matching_method,
    run_two_view,
    run_two_view_arrays,
    step12_fused_device,
)

torch.set_num_threads(2)

# rendered keypoints at 120x160 (f = 176 px): the default 3.35e-4
# threshold is 0.06 px, so both sides use the looser one the JAX suite
# uses for this renderer
OPTS = {"reprojection_error_allowed": 3e-3}


@functools.lru_cache(maxsize=1)
def rendered_pair():
    """Two 120x160 rendered views and their K file, written once per
    process (``test_torch_sift.py`` runs SIFT on the same views)."""
    from test_sfm_pipeline import _tiny_dataset

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="spectavi-torch-pair-"))
    atexit.register(shutil.rmtree, tmp, True)
    paths, kfile, _ = _tiny_dataset(tmp, np.random.default_rng(0xDEADBEEF))
    return tmp, paths[:2], kfile


@pytest.fixture
def pair():
    return rendered_pair()


def _xy_rows(a):
    return {tuple(np.round(r, 2)) for r in a}


def test_sift_rendered_views(pair):
    # SIFT parity on the pair, at the tolerances of test_torch_sift.py
    from test_torch_sift import _check

    _, paths, _ = pair
    _check([imread(p, dtype="float32", force_grayscale=True) for p in paths])


def test_run_two_view_vs_jax(pair):
    tmp, paths, kfile = pair
    gen = torch.Generator()
    gen.manual_seed(0)
    out_t = str(tmp / "torch")
    out_j = str(tmp / "jax")
    rt = run_two_view(paths, kfile, outdir=out_t, matching_method="l2-mxu", generator=gen,
                      quiet=True, ransac_options=OPTS, device="cpu")
    rj = jax_run_two_view(paths, kfile, outdir=out_j, matching_method="l2-mxu",
                          key=jax.random.PRNGKey(0), quiet=True, ransac_options=OPTS)
    mt, mj = rt["metrics"], rj["metrics"]
    assert mt["n_matches"] >= 30
    assert abs(mt["n_matches"] - mj["n_matches"]) <= 0.01 * mj["n_matches"]
    assert abs(mt["consensus"] - mj["consensus"]) <= 0.02
    # inlier sets, as the matched image points (match order may differ)
    it = _xy_rows(np.hstack([rt["matches"][0][rt["ransac"]["inlier_idx"], :2],
                             rt["matches"][1][rt["ransac"]["inlier_idx"], :2]]))
    ij = _xy_rows(np.hstack([rj["matches"][0][rj["ransac"]["inlier_idx"], :2],
                             rj["matches"][1][rj["ransac"]["inlier_idx"], :2]]))
    assert len(it & ij) / len(it | ij) >= 0.95
    with open(os.path.join(out_t, "metrics.json")) as f:
        keys_t = set(json.load(f))
    with open(os.path.join(out_j, "metrics.json")) as f:
        keys_j = set(json.load(f))
    assert keys_t == keys_j
    for a, b in zip(rt["rectified"], rj["rectified"]):
        assert a.shape == b.shape
    assert rt["points"].shape == (mt["n_inliers"], 4) and np.isfinite(rt["points"]).all()
    for name in ("sparse_inliers.ply", "metrics.json", "rect-v0.png", "rect-v1.png"):
        assert os.path.exists(os.path.join(out_t, name))


def test_step12_fused_device_vs_jax(pair):
    _, paths, _ = pair
    metas_t, (xd_t, yd_t) = step12_fused_device(paths, quiet=True, device="cpu")
    metas_j, (xd_j, yd_j) = jax_step12(paths, quiet=True)
    assert [m.shape[1] for m in metas_t] == [4, 4]
    for mt, mj in zip(metas_t, metas_j):
        assert abs(len(mt) - len(mj)) <= 0.01 * len(mj)
    assert len(xd_j) >= 30
    assert abs(len(xd_t) - len(xd_j)) <= 0.01 * len(xd_j)
    rows_t = np.hstack([xd_t[:, :2], yd_t[:, :2]])
    rows_j = np.hstack([xd_j[:, :2], yd_j[:, :2]])
    d, _ = cKDTree(rows_t).query(rows_j)
    assert (d < 0.01).mean() >= 0.99


def test_rectify_pair_quantized_vs_jax(pair):
    _, paths, kfile = pair
    K = np.loadtxt(kfile)
    a = 0.15
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    P0 = K @ np.hstack([np.eye(3), np.zeros((3, 1))])
    P1 = K @ np.hstack([R, np.array([[-1.0], [0.05], [0.1]])])
    im0 = np.array(imread(paths[0], dtype="uint8"))
    im1 = np.array(imread(paths[1], dtype="uint8"))
    got = rectify_pair_quantized(P0, P1, im0, im1, device="cpu")
    want = jax_rectify_pair_quantized(P0, P1, im0, im1)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == np.uint8 and g.shape == w.shape
        assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1


def test_rectify_pair_tensor_api_vs_jax(pair):
    _, paths, kfile = pair
    K = np.loadtxt(kfile)
    P0 = K @ np.hstack([np.eye(3), np.zeros((3, 1))])
    P1 = K @ np.hstack([np.eye(3), np.array([[-1.0], [0.05], [0.1]])])
    ims = [np.array(imread(p))[..., None] for p in paths]
    got = rectify_pair(*(torch.as_tensor(a) for a in (P0, P1, *ims)), sampling_factor=1.2)
    want = jax_rectify_pair(P0, P1, *ims, sampling_factor=1.2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_unported_options_raise(pair):
    # every matcher of the JAX package is ported; the bundle-adjustment
    # polish is what is left
    _, paths, kfile = pair
    for kw in ({"ba": True}, {"distortion": True}):
        with pytest.raises(NotImplementedError):
            run_two_view(paths, kfile, outdir=None, device="cpu", quiet=True, **kw)
    with pytest.raises(ValueError):
        run_two_view(paths, kfile, outdir=None, device="cpu", quiet=True,
                     matching_method="hnsw")


def test_resolve_matching_method():
    assert resolve_matching_method("auto", "cuda") == "l2-mxu"
    assert resolve_matching_method("auto", torch.device("cuda", 0)) == "l2-mxu"
    assert resolve_matching_method("auto", "cpu") == "cascading-hash"
    for name in ("l2-mxu", "bruteforce", "cascading-hash"):
        assert resolve_matching_method(name, "cpu") == name
        assert resolve_matching_method(name, "cuda") == name
    with pytest.raises(ValueError):
        resolve_matching_method("l1", "cpu")


@functools.lru_cache(maxsize=None)
def _jax_run(matching_method):
    _, paths, kfile = rendered_pair()
    return jax_run_two_view(paths, kfile, outdir=None, matching_method=matching_method,
                            key=jax.random.PRNGKey(0), quiet=True, ransac_options=OPTS)["metrics"]


def _decoded(paths):
    grays = [imread(p, dtype="float32", force_grayscale=True) for p in paths]
    colors = [imread(p, dtype="uint8") for p in paths]
    return grays, colors


@pytest.mark.parametrize("matching_method,resolved,count_tol,consensus_tol", [
    ("auto", "cascading-hash", 0.03, 0.04),
    ("cascading-hash", "cascading-hash", 0.03, 0.04),
    ("bruteforce", "bruteforce", 0.01, 0.02),
])
def test_run_two_view_arrays_matchers_vs_jax(pair, matching_method, resolved, count_tol,
                                             consensus_tol):
    _, paths, kfile = pair
    grays, colors = _decoded(paths)
    gen = torch.Generator()
    gen.manual_seed(0)
    rt = run_two_view_arrays(grays, colors, np.loadtxt(kfile), outdir=None,
                             matching_method=matching_method, generator=gen, quiet=True,
                             ransac_options=OPTS, device="cpu")
    mt, mj = rt["metrics"], _jax_run(resolved)
    # as the JAX package reports on its CPU backend
    assert mt["matching_method"] == resolved == mj["matching_method"]
    assert mt["fused_frontend"] is False and mj["fused_frontend"] is False
    assert mt["keypoints"] == mj["keypoints"]
    assert mt["n_matches"] >= 30 and mt["ransac_success"]
    assert abs(mt["n_matches"] - mj["n_matches"]) <= max(1, count_tol * mj["n_matches"])
    assert abs(mt["consensus"] - mj["consensus"]) <= consensus_tol
    assert rt["points"].shape == (mt["n_inliers"], 4) and np.isfinite(rt["points"]).all()


def test_plots_are_written(pair, tmp_path):
    pytest.importorskip("matplotlib")
    _, paths, kfile = pair
    grays, colors = _decoded(paths)
    run_two_view_arrays(grays, colors, np.loadtxt(kfile), outdir=str(tmp_path),
                        matching_method="l2-mxu", quiet=True, ransac_options=OPTS,
                        plots=True, device="cpu")
    for name in ("step1-keypoints.png", "step2-matches.png"):
        assert (tmp_path / name).stat().st_size > 1000
