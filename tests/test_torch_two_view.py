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
* ex01's ``--view`` opens ``<outdir>/sparse_inliers.ply`` after the run,
  as the JAX package's ex01 does.
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
    # every matcher and option of the JAX package is ported (the BA
    # polish is held to JAX below); an unknown matcher raises
    _, paths, kfile = pair
    with pytest.raises(ValueError):
        run_two_view(paths, kfile, outdir=None, device="cpu", quiet=True,
                     matching_method="hnsw")


def _ba_step3(rng, n=60, k=(-0.08, 0.02)):
    """Step 3's output for a wide-angle pair: inlier correspondences seen
    through the radial model ``k`` with noise, and a RANSAC camera off
    the true pose."""
    X = rng.standard_normal((n, 3)) * [1.5, 1.0, 0.5] + [0.0, 0.0, 4.0]
    a = 0.15
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    t = np.array([-0.8, 0.05, 0.1])

    def obs(Xc):
        p = Xc[:, :2] / Xc[:, 2:]
        r2 = np.sum(p * p, axis=1, keepdims=True)
        p = p * (1.0 + k[0] * r2 + k[1] * r2 * r2) + 1e-4 * rng.standard_normal(p.shape)
        return np.hstack([p, np.ones((n, 1))])

    x0, x1 = obs(X), obs(X @ R.T + t)
    cam = np.hstack([R, (t + 0.01 * rng.standard_normal(3))[:, None]])
    ransac = {"inlier_idx": np.arange(n), "camera": cam, "success": True,
              "inlier_percent": 1.0, "essential": np.eye(3)}
    return ransac, x0, x1, x0[:, :2], x1[:, :2]


@pytest.mark.parametrize("distortion", [False, True])
def test_two_view_ba_polish_vs_jax(rng, distortion):
    """``ba=True`` (and with ``distortion``) refines P1 and the points by
    the bundle adjustment the JAX package runs: camera, points and the
    radial block within 1e-8; ``distortion`` alone changes nothing."""
    from spectavi_tpu.pipeline.two_view import step4_triangulate as jax_step4
    from spectavi_tpu.sfm import bundle_adjust as jax_bundle_adjust
    from spectavi_tpu_torch.pipeline.two_view import step4_triangulate
    from spectavi_tpu_torch.sfm import bundle_adjust

    step3 = _ba_step3(rng)
    RXj, rj = jax_step4(step3, quiet=True, ba=True, distortion=distortion)
    RXt, rt = step4_triangulate(step3, quiet=True, ba=True, distortion=distortion, device="cpu")
    np.testing.assert_allclose(rt["camera"], rj["camera"], atol=1e-8)
    np.testing.assert_allclose(RXt, RXj, atol=1e-8)
    assert not np.allclose(rt["camera"], step3[0]["camera"])
    if distortion:
        # the radial block of that bundle adjustment (step 4 prints it)
        from spectavi_tpu_torch.sfm import rotation_to_rvec

        ransac, x0, x1 = step3[:3]
        n = x0.shape[0]
        cams0 = np.zeros((2, 6))
        cams0[1, :3] = rotation_to_rvec(ransac["camera"][:, :3])
        cams0[1, 3:] = ransac["camera"][:, 3]
        RX0 = step4_triangulate(step3, quiet=True, device="cpu")[0]
        args = (cams0, RX0[:, :3], np.repeat([0, 1], n), np.tile(np.arange(n), 2),
                np.vstack([x0[:, :2], x1[:, :2]]))
        kt = bundle_adjust(*args, max_iters=10, estimate_distortion=True, device="cpu")[3]
        kj = jax_bundle_adjust(*args, max_iters=10, estimate_distortion=True)[3]
        np.testing.assert_allclose(kt, kj, atol=1e-8)
        assert kt[0] < -0.05  # the lens's barrel term is found
    else:
        RX0, r0 = step4_triangulate(step3, quiet=True, distortion=True, device="cpu")
        np.testing.assert_array_equal(r0["camera"], step3[0]["camera"])


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


def test_ex01_view_opens_the_sparse_cloud(tmp_path, monkeypatch):
    # JAX's ex01 --view: after the run, the sparse cloud in the viewer
    from spectavi_tpu_torch.pipeline import ex01, viz

    runs, shown = [], []
    monkeypatch.setattr(ex01, "run_two_view", lambda images, K, **kw: runs.append(kw["outdir"]))
    monkeypatch.setattr(viz, "try_open3d_viz", shown.append)
    out = str(tmp_path / "out")
    ex01.main(["a.png", "b.png", "K.txt", "--device", "cpu", "--outdir", out, "--view"])
    assert runs == [out]
    assert shown == [os.path.join(out, "sparse_inliers.ply")]
    ex01.main(["a.png", "b.png", "K.txt", "--device", "cpu", "--outdir", out])
    assert len(runs) == 2 and len(shown) == 1  # without --view nothing opens


def _step_case(name, pair, monkeypatch, tmp_path):
    """``(port, JAX)`` results of one ex01 step run separately."""
    from spectavi_tpu.pipeline import two_view as jtv
    from spectavi_tpu_torch.pipeline import two_view as ttv
    from test_torch_mvg import _scene
    from test_torch_ransac import hand_jax_draws

    _, paths, kfile = pair
    K = np.loadtxt(kfile)
    if name == "step1_sift_detect":
        return (ttv.step1_sift_detect(paths, quiet=True, device="cpu"),
                jtv.step1_sift_detect(paths, quiet=True))
    x0, x1 = _scene(np.random.default_rng(3), n=200)
    xd, yd = (np.hstack([x, np.ones((len(x), 1))]) @ K.T for x in (x0, x1))
    if name == "step3_estimate_essential":
        hand_jax_draws(monkeypatch, 2)
        return (ttv.step3_estimate_essential(xd, yd, K, quiet=True, device="cpu"),
                jtv.step3_estimate_essential(xd, yd, K, key=jax.random.PRNGKey(2), quiet=True))
    # step 5 given one camera, writing the rectified pair
    ransac = {"camera": np.hstack([np.eye(3), np.array([[-1.0], [0.1], [0.2]])])}
    outs = []
    for side, step5 in (("port", ttv.step5_rectify), ("jax", jtv.step5_rectify)):
        d = tmp_path / side
        d.mkdir()
        kw = {"device": "cpu"} if side == "port" else {}
        res = step5(ransac, K, paths, outdir=str(d), sampling_factor=1.0, quiet=True, **kw)
        files = [imread(str(d / ("rect-" + os.path.basename(p))), dtype="uint8") for p in paths]
        outs.append((res, files))
    return outs


@pytest.mark.parametrize("name", ["step1_sift_detect", "step3_estimate_essential",
                                  "step5_rectify"])
def test_steps_vs_jax(pair, monkeypatch, tmp_path, name):
    got, ref = _step_case(name, pair, monkeypatch, tmp_path)
    if name == "step1_sift_detect":
        # test_torch_sift.py's rule
        from test_torch_sift import _agreement

        for g, r in zip(got, ref):
            assert abs(len(g) - len(r)) <= 0.01 * len(r)
            assert min(_agreement(r, g)) >= 0.99
    elif name == "step3_estimate_essential":
        # given JAX's draws: JAX's winner, and the same calibrated points
        (rt, *pts_t), (rj, *pts_j) = got, ref
        np.testing.assert_array_equal(rt["inlier_idx"], np.asarray(rj["inlier_idx"]))
        assert rt["success"] == rj["success"] and rt["inlier_percent"] == rj["inlier_percent"]
        np.testing.assert_allclose(rt["camera"], np.asarray(rj["camera"]), atol=1e-9)
        for a, b in zip(pts_t, pts_j):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-15)
    else:
        # the same float64 rectification, and the same pixels from the
        # files (JAX writes with Pillow, the port with its codec)
        (res_t, files_t), (res_j, files_j) = got, ref
        for a, b in zip(res_t, res_j):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(files_t, files_j):
            assert a.dtype == b.dtype == np.uint8
            np.testing.assert_array_equal(a, b)
