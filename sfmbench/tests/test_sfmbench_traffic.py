"""Each traffic kind and the reference at a small size on the CPU, and
the control on the card."""

import io
import json

import numpy as np
import pytest
import torch

from sfmbench import harness, scene
from sfmbench.reference import judge


def _ctx(bench, cell_name, seed=2**31 + 11, device="cpu"):
    cell = harness.Cell(bench, cell_name)
    ctx = harness.Context(cell, seed, 1, 0, torch.device(device))
    ctx.sync = lambda: None
    return cell, ctx


def test_scene_is_a_decode_of_rgb():
    s = scene.render_scene(3, 48, 64, "cpu", (20, 30), seed=5)
    assert len(s["grays"]) == 3
    for g, c in zip(s["grays"], s["colors"]):
        assert g.dtype == np.float32 and g.shape == (48, 64) and g.max() == 1.0
        assert c.dtype == np.uint8 and c.shape == (48, 64, 3)
        assert not np.array_equal(c[..., 0], c[..., 1])
    R, t = scene.relative_pose(s["poses"], 0, 2)
    assert np.allclose(R @ R.T, np.eye(3))


def test_two_view_arrays_job_and_reference(tiny_bench, tiny):
    bench = tiny_bench(tiny)
    cell, ctx = _ctx(bench, "castle-pair")
    gen = harness.generator_module(cell.kind)
    st = gen.setup(ctx)
    assert len(st.pairs) == cell.traffic["pool"]
    outs = [gen.job(ctx, st, i) for i in range(2)]
    outs[0]["rectified"] = None
    nums = gen.check(ctx, st, outs)
    assert set(nums) == {"match_diff", "consensus_diff", "inlier_diff", "point_err",
                         "rect_diff", "rotation_deg", "translation_deg"}
    # the program's plain path on the CPU is the reference's arithmetic,
    # and its replay of step 3 draws the same tables
    assert nums["match_diff"][0] == 0.0
    assert nums["consensus_diff"][0] == 0.0
    assert nums["inlier_diff"][0] == 0.0
    assert nums["point_err"][0] <= 1e-12
    assert nums["translation_deg"][0] < 10.0


def test_sfm_arrays_job_and_reference(tiny_bench, tiny):
    bench = tiny_bench(tiny)
    cell, ctx = _ctx(bench, "tum-seq10")
    gen = harness.generator_module(cell.kind)
    st = gen.setup(ctx)
    try:
        out = gen.job(ctx, st, 0)
    finally:
        st = gen.release(ctx, st)
    assert out["cams"].shape == (cell.config["views_per_job"], 6)
    nums = gen.check(ctx, st, [out])
    assert set(nums) == {"feature_diff", "pair_match_diff", "pair_inlier_diff", "track_diff",
                         "ate_pct", "ba_diff"}
    # the program's plain path on the CPU is the reference's arithmetic
    for k in ("feature_diff", "pair_match_diff", "pair_inlier_diff", "track_diff"):
        assert nums[k][0] == 0.0, (k, nums[k])


def test_row_diff_pairs_rows_by_key_and_angle():
    ref = np.array([[1, 2, 3, 0.50], [1, 2, 3, 1.00], [4, 5, 6, 0.0]], np.float32)
    assert judge.row_diff(ref, ref, [0, 1, 2]) == 0.0
    moved = ref.copy()
    moved[0, 3] += 1e-4
    assert judge.row_diff(moved, ref, [0, 1, 2]) == 0.0
    moved[1, 0] += 1.0
    assert judge.row_diff(moved, ref, [0, 1, 2]) == pytest.approx(2 / 3)
    assert judge.row_diff(ref[:2], ref, [0, 1, 2]) == pytest.approx(1 / 3)


def test_reference_triangulation_and_inliers_on_a_known_pair():
    rng = np.random.default_rng(0)
    K = scene.camera_K(480, 640)
    X = np.c_[rng.uniform(-1, 1, (200, 2)), rng.uniform(3, 6, 200)]
    R, _ = np.linalg.qr(rng.normal(size=(3, 3)) * 0.01 + np.eye(3))
    R = R * np.sign(np.diag(R))[None, :]
    t = np.array([1.0, 0.1, 0.05])
    x0 = (K @ X.T).T
    x1 = (K @ (X @ R.T + t).T).T
    xd, yd = x0[:, :2] / x0[:, 2:], x1[:, :2] / x1[:, 2:]
    cam = np.hstack([R, t[:, None]])
    mask = judge.inlier_mask(xd, yd, K, cam, 3.35e-4, "cpu")
    assert mask.all()
    pts = judge.triangulate(xd, yd, K, cam, np.arange(200), "cpu")
    assert np.allclose(pts[:, :3], X, rtol=1e-9)
    assert judge.point_err(pts, np.c_[X, np.ones(200)]) < 1e-9


def test_ate_of_a_similar_trajectory_is_zero():
    rng = np.random.default_rng(1)
    cams = np.c_[rng.normal(scale=0.1, size=(5, 3)), rng.normal(size=(5, 3))]
    C = judge.geometry.camera_centres(cams)
    assert judge.geometry.ate_share(cams, 2.5 * C + 1.0) < 1e-12


@pytest.mark.card
def test_control_fails_on_the_card(card):
    """The control, the reference a precision below in the program's
    place, comes out not correct on three seeds, at a size a test run
    holds (the benchmark's readings at the cells' own sizes are in
    PERF.md)."""
    from sfmbench import control

    bench = harness.load_json(harness.ROOT + "/BENCHMARK.json")
    rows = control.readings("castle-pair", [101, 102, 103], 2.0, device="cuda", bench=bench,
                            out=io.StringIO())
    for row in rows:
        assert row["control_fails"], json.dumps(row)
        assert not row["program_fails"], json.dumps(row)
