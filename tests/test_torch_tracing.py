"""The port's tracer (``spectavi_tpu_torch.utils.profiling``): the off
path, nested spans with their parents and job ids, counters shared with
the innermost span, the pipelines' step trees and ``*_seconds``, and
``--trace DIR`` of both CLIs."""

import glob
import json
import os
import warnings

import numpy as np
import pytest
import torch

from spectavi_tpu_torch.utils import profiling

torch.set_num_threads(2)


@pytest.fixture
def tracing():
    """Recording on for the test, off and emptied after it."""
    profiling.take()
    was = profiling.enable()
    yield profiling
    profiling.enable(was)
    profiling.take()


def _tree(rec):
    """``rec["spans"]`` as ``(depth, name)`` rows in opening order."""
    depth, rows = {}, []
    for i, s in enumerate(rec["spans"]):
        depth[i] = 0 if s["parent"] < 0 else depth[s["parent"]] + 1
        rows.append((depth[i], s["name"]))
    return rows


def _children(rec, name):
    spans = rec["spans"]
    parents = {i for i, s in enumerate(spans) if s["name"] == name}
    return {s["name"] for s in spans if s["parent"] in parents}


def test_off_path_records_nothing_and_shares_one_context():
    was = profiling.disable()
    try:
        profiling.take()
        a, b = profiling.annotate("a"), profiling.annotate("b")
        assert a is b
        with a:
            profiling.count("ransac_trials")
            profiling.count("ransac_trials", 3)
        step = profiling.step("s")
        with step:
            pass
        assert step.elapsed is not None and step.elapsed >= 0
        assert profiling.take() == {"spans": [], "counters": {}}
    finally:
        profiling.enable(was)


def test_nested_spans_keep_parent_and_job_and_take_clears(tracing):
    with profiling.annotate("root"):
        with profiling.annotate("child"):
            with profiling.step("leaf") as leaf:
                pass
        with profiling.annotate("child2"):
            pass
    with profiling.annotate("root"):
        pass
    rec = profiling.take()
    names = [s["name"] for s in rec["spans"]]
    assert names == ["root", "child", "leaf", "child2", "root"]
    parents = [s["parent"] for s in rec["spans"]]
    assert parents == [-1, 0, 1, 0, -1]
    jobs = [s["job"] for s in rec["spans"]]
    assert jobs[:4] == [jobs[0]] * 4 and jobs[4] != jobs[0]
    for s in rec["spans"]:
        assert s["start_ns"] <= s["end_ns"]
    assert leaf.elapsed == pytest.approx((rec["spans"][2]["end_ns"]
                                          - rec["spans"][2]["start_ns"]) * 1e-9)
    assert profiling.take() == {"spans": [], "counters": {}}


def test_count_goes_to_the_innermost_open_span(tracing):
    profiling.count("ransac_trials", 5)
    with profiling.annotate("outer"):
        profiling.count("host_sync")
        with profiling.annotate("inner"):
            profiling.count("host_sync", 2)
            profiling.count("ransac_trials", 7)
        profiling.count("host_sync")
    rec = profiling.take()
    counts = {s["name"]: s["counts"] for s in rec["spans"]}
    assert counts["outer"] == {"host_sync": 2}
    assert counts["inner"] == {"host_sync": 2, "ransac_trials": 7}
    assert rec["counters"] == {"ransac_trials": 12, "host_sync": 4}


def _report(message="called a synchronizing CUDA operation (Triggered internally)"):
    warnings.warn(message, stacklevel=1)


def test_sync_reports_count_as_host_sync_in_the_innermost_span(tracing, monkeypatch):
    # the runtime's reports, as the sync debug mode issues them on a card
    modes = []
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    here = os.path.dirname(os.path.abspath(__file__)) + os.sep
    profiling._watch_syncs(True)
    try:
        with profiling.annotate("outer"):
            _report()  # issued outside the package: not the program's
            monkeypatch.setattr(profiling, "_PACKAGE", here)
            with profiling.annotate("read"):
                _report()
                _report()
            _report()
            with pytest.warns(UserWarning, match="another warning"):
                _report("another warning")
    finally:
        profiling._watch_syncs(False)
    assert modes == ["warn", 0]
    rec = profiling.take()
    counts = {s["name"]: s["counts"] for s in rec["spans"]}
    assert counts == {"outer": {"host_sync": 1}, "read": {"host_sync": 2}}
    assert rec["counters"] == {"host_sync": 3}
    with pytest.warns(UserWarning, match="synchronizing"):
        _report()
    assert profiling.take()["counters"] == {}


def test_timer_is_a_step_span(tracing, capsys):
    from spectavi_tpu_torch.pipeline.io import Timer

    with Timer("step9-computation", False, "nine") as t:
        pass
    with Timer("quiet step", True) as q:
        pass
    assert t.elapsed >= 0 and q.elapsed >= 0
    assert "step9-computation: " in capsys.readouterr().out
    assert [s["name"] for s in profiling.take()["spans"]] == ["nine", "quiet step"]


def test_trace_turns_recording_on_inside_it(tmp_path):
    was = profiling.disable()
    try:
        with profiling.trace(str(tmp_path / "prof")):
            assert profiling.enabled()
            with profiling.annotate("inside"):
                torch.ones(8) + 1
        assert not profiling.enabled()
        assert [s["name"] for s in profiling.take()["spans"]] == ["inside"]
    finally:
        profiling.enable(was)


@pytest.fixture(scope="module")
def pair():
    import chip_smoke

    return chip_smoke.render_pair(240, 320, "cpu", (50, 70))


def test_two_view_step_tree(pair, tracing):
    from spectavi_tpu_torch.pipeline.two_view import run_two_view_arrays

    grays, colors, K, _ = pair
    res = run_two_view_arrays(grays, colors, K, device="cpu", quiet=True,
                              matching_method="l2-mxu")
    rec = profiling.take()
    tree = _tree(rec)
    assert tree[0] == (0, "two_view")
    assert [n for d, n in tree if d == 1] == ["sift", "match", "ransac", "triangulate",
                                             "rectify"]
    assert {"sift.upload", "sift.detect", "sift.orient", "sift.select", "sift.describe",
            "sift.download"} == _children(rec, "sift")
    assert _children(rec, "match") == {"quantize", "match.nn", "ratio"}
    assert _children(rec, "ransac") == {"ransac.block", "ransac.download"}
    assert len({s["job"] for s in rec["spans"]}) == 1
    assert rec["counters"]["ransac_trials"] >= 1
    # nothing waits on the CPU: the runtime reports no synchronization
    assert "host_sync" not in rec["counters"]
    m = res["metrics"]
    for k in ("step1_seconds", "step2_seconds", "step3_seconds", "step4_seconds",
              "step5_seconds", "decode_seconds", "total_seconds"):
        assert k in m and m[k] >= 0
    spans = {s["name"]: (s["end_ns"] - s["start_ns"]) * 1e-9 for s in rec["spans"]
             if s["parent"] == 0}
    assert m["step3_seconds"] == pytest.approx(spans["ransac"])


def test_sfm_step_tree(tracing):
    import chip_smoke
    from spectavi_tpu_torch.pipeline.sfm import run_sfm_arrays

    grays, K, _ = chip_smoke.tiny_views("cpu")
    res = run_sfm_arrays(grays, K, device="cpu", quiet=True, pair_backend="batched")
    rec = profiling.take()
    tree = _tree(rec)
    assert tree[0] == (0, "sfm")
    top = [n for d, n in tree if d == 1]
    assert top == ["sift", "pairs", "tracks", "graph", "triangulate", "ba"]
    assert "sift.detect" in _children(rec, "sift")
    assert _children(rec, "pairs") >= {"pairs.batch", "pairs.collect"}
    assert _children(rec, "pairs.batch") >= {"pairs.upload", "pairs.match", "pairs.ransac",
                                             "pairs.download", "pairs.unpack"}
    assert _children(rec, "graph") >= {"graph.triangulate", "graph.pnp"}
    assert rec["counters"]["ransac_trials"] >= 8192
    m = res["metrics"]
    for k in ("sift_seconds", "pairs_seconds", "graph_seconds", "ba_seconds"):
        assert k in m and m[k] > 0
    spans = {s["name"]: (s["end_ns"] - s["start_ns"]) * 1e-9 for s in rec["spans"]
             if s["parent"] == 0}
    assert m["graph_seconds"] == pytest.approx(
        spans["tracks"] + spans["graph"] + spans["triangulate"])
    assert m["ba_seconds"] == pytest.approx(spans["ba"])


def _trace_names(logdir):
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_ex01_trace_holds_the_step_tree(pair, tmp_path):
    from spectavi_tpu_torch.pipeline import ex01
    from spectavi_tpu_torch.pipeline.io import imsave

    grays, colors, K, _ = pair
    paths = []
    for i, c in enumerate(colors):
        paths.append(str(tmp_path / f"im{i}.png"))
        imsave(paths[-1], c)
    np.savetxt(tmp_path / "K.txt", K)
    logdir = str(tmp_path / "trace")
    ex01.main([*paths, str(tmp_path / "K.txt"), "--outdir", str(tmp_path / "out"),
               "--device", "cpu", "--matching_method", "l2-mxu", "--trace", logdir])
    names = _trace_names(logdir)
    assert {"frontend", "sift"} & names
    assert {"cli", "decode", "two_view", "ransac", "rectify", "write"} <= names
    assert not profiling.enabled()
    profiling.take()


def test_ex02_trace_holds_the_step_tree(tmp_path):
    import chip_smoke
    from spectavi_tpu_torch.pipeline import ex02
    from spectavi_tpu_torch.pipeline.io import imsave

    grays, K, _ = chip_smoke.tiny_views("cpu")
    paths = []
    for i, g in enumerate(grays):
        paths.append(str(tmp_path / f"v{i}.png"))
        imsave(paths[-1], np.round(g * 255).astype(np.uint8))
    np.savetxt(tmp_path / "K.txt", K)
    logdir = str(tmp_path / "trace")
    ex02.main([*paths, str(tmp_path / "K.txt"), "--outdir", str(tmp_path / "out"),
               "--device", "cpu", "--trace", logdir])
    names = _trace_names(logdir)
    assert {"cli", "decode", "sfm", "sift", "pairs", "tracks", "graph", "triangulate", "ba",
            "write"} <= names
    assert os.path.getsize(tmp_path / "out" / "poses.txt") > 0
    profiling.take()
