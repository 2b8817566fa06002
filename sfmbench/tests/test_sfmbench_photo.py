"""The ``sfm_photo`` traffic kind and the ``fountain-exh11`` cell on the
CPU: the reference's pair step is handed the program's sized bucket,
the check reads 0 on the program's own answers and catches a pair step
that cuts survivors, set-up refuses a program without the sized bucket,
and the configuration, traffic mix, cell and metrics are found by name
as files."""

import json
import os
import subprocess
import sys

import pytest
import torch

from sfmbench import harness

CONFIG = "strecha-fountain-3072x2048"
CELL = "fountain-exh11"
FLOOR = 256


@pytest.fixture
def photo_cell(tiny_bench, monkeypatch):
    """The cell at 3 views of 240x320 on the batched pair step, a size at
    which the batch answers every pair itself (none is retried on the
    loop path), its bucket's floor at 256 rows on both sides so that the
    bucket grows past it; ``buckets`` collects the program's bucket
    sizes."""
    from spectavi_tpu_torch.parallel import two_view
    from spectavi_tpu_torch.pipeline import sfm as psfm

    bench = tiny_bench({CONFIG: {"height": 240, "width": 320, "texture": [50, 75],
                                 "views_per_job": 3,
                                 "settings": {"pair_backend": "batched"}}})
    cell = harness.Cell(bench, CELL)
    ctx = harness.Context(cell, 2**31 + 11, 1, 0, torch.device("cpu"))
    ctx.sync = lambda: None
    gen = harness.generator_module(cell.kind)
    monkeypatch.setattr(gen, "FLOOR", FLOOR)
    step = psfm._match_pairs_batched
    monkeypatch.setattr(psfm, "_match_pairs_batched",
                        lambda *a, **k: step(*a, **dict(k, compact_to=FLOOR)))
    buckets = []
    rows = two_view.bucket_rows

    def kept(*a, **k):
        buckets.append(rows(*a, **k))
        return buckets[-1]

    monkeypatch.setattr(two_view, "bucket_rows", kept)
    retried = []
    loop = psfm._match_pair_loop
    monkeypatch.setattr(psfm, "_match_pair_loop",
                        lambda *a, **k: retried.append(a[2:4]) or loop(*a, **k))
    return ctx, gen, buckets, retried


def _answer(ctx, gen, st=None):
    st = gen.setup(ctx) if st is None else st
    try:
        out = gen.job(ctx, st, 0)
    finally:
        st = gen.release(ctx, st)
    return st, out


def test_reference_gets_the_programs_bucket(photo_cell, capfd):
    ctx, gen, buckets, retried = photo_cell
    st, out = _answer(ctx, gen)
    assert len(out["pairs"]) == 3 and not retried
    # the step's bucket and the unpacking's, both past the floor
    assert len(buckets) == 2 and buckets[0] == buckets[1] > FLOOR
    capfd.readouterr()
    nums = gen.check(ctx, st, [out])
    said = [ln for ln in capfd.readouterr().err.splitlines() if ln.startswith("pair step bucket")]
    assert said and all(int(ln.split()[3]) == buckets[0] for ln in said)
    assert set(nums) == set(gen.NUMBERS)
    # the program's plain path on the CPU is the reference's arithmetic
    for k in ("feature_diff", "pair_match_diff", "pair_inlier_diff", "track_diff", "ba_diff"):
        assert nums[k][0] == 0.0, (k, nums[k])


def test_check_catches_a_step_that_cuts_survivors(photo_cell, monkeypatch):
    from spectavi_tpu_torch.parallel import two_view

    ctx, gen, _, retried = photo_cell
    st = gen.setup(ctx)
    make = two_view.make_two_view_step
    monkeypatch.setattr(two_view, "make_two_view_step",
                        lambda *a, **k: make(*a, **dict(k, sized=False)))
    st, out = _answer(ctx, gen, st)
    assert not retried
    nums = gen.check(ctx, st, [out])
    assert nums["pair_inlier_diff"][0] > nums["pair_inlier_diff"][1]


def test_setup_refuses_a_step_without_the_sized_bucket(photo_cell, monkeypatch):
    from spectavi_tpu_torch.parallel import two_view

    ctx, gen, _, _ = photo_cell
    fixed = two_view.make_two_view_step

    def step(mesh=None, trials=512, reproj_allowed=1e-3, svr_allowed=3e-2, min_ratio=1.75,
             masked=False, compact_to=4096):
        return fixed(mesh, trials, reproj_allowed, svr_allowed, min_ratio, masked, compact_to)

    monkeypatch.setattr(two_view, "make_two_view_step", step)
    with pytest.raises(SystemExit, match="fixed bucket"):
        gen.setup(ctx)


def test_cell_found_as_files_only():
    """The configuration, traffic mix, cell and per-layer metrics of
    ``fountain-exh11``, found by the harness by name in a fresh
    process."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from sfmbench import harness\n"
        "b = harness.load_json(%r)\n"
        "c = harness.Cell(b, %r)\n"
        "g = harness.generator_module(c.kind)\n"
        "assert all(callable(getattr(g, f)) for f in ('setup', 'job', 'check', 'control'))\n"
        "rs = [harness.metric_reader(m['name']) for m in c.per_layer]\n"
        "run = harness.Run(); run.job_s = [1.0]; run.program = []\n"
        "print(c.kind, c.config['name'], c.config['views_per_job'], c.chips,"
        " sorted(m['name'] for m in c.end_to_end),"
        " [r.read(run) for r in rs[-2:]])\n"
    ) % (harness.ROOT, os.path.join(harness.ROOT, "BENCHMARK.json"), CELL)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    words = out.stdout.split(maxsplit=4)
    assert words[:4] == ["sfm_photo", CONFIG, "11", "1"]
    assert words[4].strip() == "['setup_s', 'sfm_s'] [None, None]"

    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    cell = harness.Cell(bench, CELL)
    names = [m["name"] for m in cell.per_layer]
    multi = {w["name"] for w in bench["workloads"] if w["config"] != "strecha-castle-3072x2048"}
    for m in bench["per_layer"]:
        if m["name"].endswith(".sfm"):
            assert CELL in m["workloads"] and m["name"] in names
    for name in ("pair_survivors.sfm", "ba_observations.sfm"):
        (m,) = [m for m in bench["per_layer"] if m["name"] == name]
        assert set(m["workloads"]) == multi and m["source"] == "program_counter"
    cfg = harness.load_json(os.path.join(harness.ROOT, "sfmbench", "configs", CONFIG + ".json"))
    assert (cfg["height"], cfg["width"], cfg["reduced"]) == (2048, 3072, [])
    assert json.load(open(os.path.join(harness.HERE, "workloads", "exh11.json"))) == {
        "kind": "sfm_photo", "pool": 2, "pairs": "exhaustive", "ba_checks": 1, "profile_jobs": 1}
