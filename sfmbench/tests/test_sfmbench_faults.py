"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run on the CPU, at a size where the sound run is correct, once sound
and once with one fault planted in the program: an answer altered where
it is produced, half of the batch left out (SIFT's keypoints, the pair
step's pairs or each pair's inliers), a step that returns its state
unchanged, and a search of fewer RANSAC hypotheses.  The exchange between chips does not exist in these
one-chip cells."""

import io

import numpy as np
import pytest

from sfmbench import harness


def _run(cell, seconds=1.0):
    out, err = io.StringIO(), io.StringIO()
    args = harness.parse_args(["--workload", cell.name, "--seed", "2147483701",
                               "--seconds", str(seconds), "--trace", "0"])
    code, res = harness.run_cell(args, device="cpu", cell=cell, out=out, err=err)
    assert code == 0, err.getvalue()[-2000:]
    return res


@pytest.fixture
def pair_cell(tiny_bench, tiny):
    cell = harness.Cell(tiny_bench(tiny), "castle-pair")
    # the CPU rectifies by the float64 reference API, not the card's
    # float32 path that the reference holds it to: no pair is kept
    cell.traffic = dict(cell.traffic, pool=1, rect_every=10**9)
    return cell


@pytest.fixture
def seq_cell(tiny_bench, tiny, monkeypatch):
    """tum-seq10 at 4 views of 240x320, its final BA routed on the CPU
    through ``bundle_adjust_device``, the card's path, whose state the
    reference follows."""
    import importlib

    import spectavi_tpu_torch.pipeline.sfm as psfm

    # the package's ``bundle_adjust`` attribute is the function: take
    # the module by its full name
    pba = importlib.import_module("spectavi_tpu_torch.sfm.bundle_adjust")
    over = dict(tiny)
    over["tum-rgbd-640x480"] = dict(tiny["tum-rgbd-640x480"], height=240, width=320,
                                    texture=[50, 75], views_per_job=4)
    cell = harness.Cell(tiny_bench(over), "tum-seq10")
    cell.traffic = dict(cell.traffic, pool=1, ba_checks=1)
    monkeypatch.setattr(psfm, "bundle_adjust", lambda *a, **k: pba.bundle_adjust_device(*a, **k))
    return cell


def test_pair_sound_then_answer_altered(pair_cell, monkeypatch):
    res = _run(pair_cell)
    assert res["correct"], res["checks"]
    import spectavi_tpu_torch.mvg as mvg

    fit = mvg.ransac_fitter

    def turned(*a, **k):
        res = dict(fit(*a, **k))
        c, s = np.cos(0.1), np.sin(0.1)
        res["camera"] = np.asarray(res["camera"], np.float64).copy()
        res["camera"][:, 3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]) @ res["camera"][:, 3]
        return res

    monkeypatch.setattr(mvg, "ransac_fitter", turned)
    res = _run(pair_cell)
    assert not res["correct"]
    assert res["checks"]["translation_deg"]["value"] > res["checks"]["translation_deg"]["limit"]


def test_pair_half_of_the_batch_left_out(pair_cell, monkeypatch):
    import spectavi_tpu_torch.pipeline.two_view as tv

    step1 = tv.step1_sift_detect

    def half(*a, **k):
        kps = step1(*a, **k)
        return [kps[0], kps[1][: kps[1].shape[0] // 2]]

    monkeypatch.setattr(tv, "step1_sift_detect", half)
    res = _run(pair_cell)
    assert not res["correct"]
    assert res["checks"]["match_diff"]["value"] > res["checks"]["match_diff"]["limit"]


def test_seq_sound_then_state_unchanged(seq_cell, monkeypatch):
    res = _run(seq_cell)
    assert res["correct"], res["checks"]
    import importlib

    pba = importlib.import_module("spectavi_tpu_torch.sfm.bundle_adjust")
    monkeypatch.setattr(pba, "bundle_adjust_device",
                        lambda cams, pts, *a, **k: (np.asarray(cams), np.asarray(pts), [1.0, 1.0]))
    res = _run(seq_cell)
    assert not res["correct"]
    assert res["checks"]["ba_diff"]["value"] > res["checks"]["ba_diff"]["limit"]


def test_seq_half_of_the_batch_left_out(seq_cell, monkeypatch):
    import spectavi_tpu_torch.features as features

    sift = features.sift_filter_batch

    def half(ims, *a, **k):
        return [kp[: kp.shape[0] // 2] for kp in sift(ims, *a, **k)]

    # the pipeline takes SIFT from the package at each call
    monkeypatch.setattr(features, "sift_filter_batch", half)
    res = _run(seq_cell)
    assert not res["correct"]
    assert res["checks"]["feature_diff"]["value"] > res["checks"]["feature_diff"]["limit"]


def _half_the_pairs(results):
    return results[: len(results) // 2]


def _half_of_each_pairs_inliers(results):
    out = []
    for r in results:
        r = dict(r)
        keep = len(r["idx_j"]) // 2
        r["idx_i"], r["idx_j"] = r["idx_i"][:keep], r["idx_j"][:keep]
        out.append(r)
    return out


@pytest.mark.parametrize("fault", [_half_the_pairs, _half_of_each_pairs_inliers],
                         ids=["half_the_pairs", "half_of_each_pairs_inliers"])
def test_seq_pair_step_half_left_out(seq_cell, monkeypatch, fault):
    """Half of the pair step's batch left out: half of its pairs, or
    half of each pair's inliers."""
    import spectavi_tpu_torch.pipeline.sfm as psfm

    step = psfm._match_pairs_batched
    monkeypatch.setattr(psfm, "_match_pairs_batched", lambda *a, **k: fault(step(*a, **k)))
    res = _run(seq_cell)
    assert not res["correct"]
    checks = res["checks"]
    assert checks["pair_inlier_diff"]["value"] > checks["pair_inlier_diff"]["limit"]
    if fault is _half_of_each_pairs_inliers:
        # the tracks of the full inliers of the program's cameras
        assert checks["track_diff"]["value"] > checks["track_diff"]["limit"]


def test_pair_fewer_hypotheses(pair_cell, monkeypatch):
    """Step 3 searching fewer hypotheses (one block of 2048 trials)
    reaches another consensus than the reference's replay of the stated
    search."""
    import spectavi_tpu_torch.mvg as mvg

    fit = mvg.ransac_fitter

    def fewer(x0, x1, options=None, **k):
        opts = dict(options or {}, maximum_tries=2048)
        return fit(x0, x1, options=opts, **k)

    monkeypatch.setattr(mvg, "ransac_fitter", fewer)
    res = _run(pair_cell)
    assert not res["correct"]
    assert res["checks"]["consensus_diff"]["value"] > res["checks"]["consensus_diff"]["limit"]
