"""The harness on the CPU: discovery by name, the result line, the
import guard, and a cell, configuration and metric added as files only."""

import io
import json
import os
import shutil
import subprocess
import sys

import pytest

from sfmbench import harness

ROOT = harness.ROOT


def _bench():
    return harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def test_every_name_resolves_to_its_files():
    bench = _bench()
    for c in bench["configs"]:
        cfg = harness.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) <= set(cfg)
    for w in bench["workloads"]:
        cell = harness.Cell(bench, w["name"])
        assert os.path.exists(os.path.join(harness.HERE, "traffic", cell.kind + ".py"))
        gen = harness.generator_module(cell.kind)
        for fn in ("setup", "job", "check", "control"):
            assert callable(getattr(gen, fn))
        names = [m["name"] for m in cell.end_to_end + cell.per_layer]
        assert "setup_s" in names
        for m in cell.per_layer:
            reader = harness.metric_reader(m["name"])
            for targets in getattr(reader, "SPANS", {}).values():
                for t in targets:
                    owner, attr = harness.resolve(t)
                    assert callable(getattr(owner, attr))
        limits = cell.config["limits"]
        assert all(isinstance(v, (int, float)) for v in limits.values())


def test_cells_report_their_metrics():
    bench = _bench()
    for w in bench["workloads"]:
        cell = harness.Cell(bench, w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        assert all(m["moves"] in e2e for m in cell.per_layer)


def test_guard_compares_whole_top_level_names():
    assert harness.forbidden_loaded(["spectavi_tpu_torch", "spectavi_tpu_torch.ops", "jaxtyping"]) == []
    assert harness.forbidden_loaded(["jax.numpy", "numpy"]) == ["jax"]
    assert harness.forbidden_loaded(["spectavi_tpu.mvg", "flax"]) == ["flax", "spectavi_tpu"]
    assert harness.forbidden_loaded(["jaxlib"]) == ["jaxlib"]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import sfmbench.reference.judge, sfmbench.scene, sfmbench.bounds\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'spectavi_tpu', 'spectavi_tpu_torch'})\n"
            "print(bad)" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_needs_a_card_and_prints_no_result(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out, err = io.StringIO(), io.StringIO()
    args = harness.parse_args(["--workload", "castle-pair", "--seed", "1", "--seconds", "1"])
    code, res = harness.run_cell(args, out=out, err=err)
    assert code != 0 and res is None and out.getvalue() == ""


def test_run_fails_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    paths: the run exits non-zero and prints no result."""
    shutil.copytree(harness.HERE, tmp_path / "sfmbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = subprocess.run([sys.executable, "sfmbench/run.py", "--workload", "castle-pair", "--seed",
                        "5", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_result_line_on_the_cpu(tiny_bench, tiny):
    bench = tiny_bench(tiny)
    out, err = io.StringIO(), io.StringIO()
    args = harness.parse_args(["--workload", "castle-pair", "--seed", "2147483659",
                               "--seconds", "1", "--trace", "0"])
    code, res = harness.run_cell(args, device="cpu", bench=bench, out=out, err=err)
    assert code == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert set(line["metrics"]) == {"pair_s", "pair_p90_s", "setup_s"} or \
        set(line["metrics"]) == {"pair_s", "setup_s"}
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"] == "s"
    assert line["attempted"] >= 1 and line["failed"] == 0
    names = list(line["checks"])
    tail = err.getvalue().strip().splitlines()[-len(names):]
    assert [t.split()[0] for t in tail] == names
    assert all(" limit " in t for t in tail)
    # the front end and geometry agree with the reference at this size
    for k in ("match_diff", "inlier_diff", "point_err"):
        assert line["checks"][k]["value"] <= line["checks"][k]["limit"], k


def test_same_seed_same_inputs(tiny_bench, tiny):
    bench = tiny_bench(tiny)
    cell = harness.Cell(bench, "castle-pair")
    gen = harness.generator_module(cell.kind)
    import torch

    states = []
    for _ in range(2):
        ctx = harness.Context(cell, 2**31 + 7, 1, 0, torch.device("cpu"))
        states.append((gen.setup(ctx), ctx.job_seed(3)))
    (a, sa), (b, sb) = states
    assert sa == sb
    assert list(a.order) == list(b.order)
    for pa, pb in zip(a.pairs, b.pairs):
        for x, y in zip(pa["colors"], pb["colors"]):
            assert (x == y).all()


def test_a_cell_added_as_files_only(tmp_path):
    """A copy of the benchmark with a new configuration, traffic mix,
    cell and per-layer metric added as files and entries: the harness
    finds all of them by name, no file that was there edited."""
    root = tmp_path
    shutil.copytree(harness.HERE, root / "sfmbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = _bench()
    cfg = harness.load_json(os.path.join(ROOT, bench["configs"][0]["file"]))
    cfg["name"] = "castle-half"
    (root / "sfmbench" / "configs" / "castle-half.json").write_text(json.dumps(cfg))
    (root / "sfmbench" / "workloads" / "pair-pool1.json").write_text(json.dumps(
        {"kind": "two_view_arrays", "pool": 1, "rect_every": 4, "profile_jobs": 1}))
    (root / "sfmbench" / "metrics" / "jobs_n.pair.py").write_text(
        "def read(run):\n    return run.jobs\n")
    bench["configs"].append(dict(bench["configs"][0], name="castle-half",
                                 file="sfmbench/configs/castle-half.json"))
    bench["workloads"].append({"name": "castle-half.pool1", "config": "castle-half",
                               "traffic": "pair-pool1", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if "castle-pair" in m.get("workloads", []):
            m["workloads"].append("castle-half.pool1")
    bench["per_layer"].append({"name": "jobs_n.pair", "unit": "jobs", "better": "higher",
                               "source": "host_clock", "layer": "test", "moves": "pair_s",
                               "workloads": ["castle-half.pool1"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys; sys.path.insert(0, %r); sys.path.insert(1, %r)\n"
        "from sfmbench import harness\n"
        "assert harness.HERE.startswith(%r), harness.HERE\n"
        "b = harness.load_json(%r)\n"
        "c = harness.Cell(b, 'castle-half.pool1', root=%r)\n"
        "r = harness.metric_reader('jobs_n.pair')\n"
        "run = harness.Run(); run.job_s = [1.0, 2.0]\n"
        "print(c.kind, c.traffic['pool'], c.config['name'], [m['name'] for m in c.per_layer],"
        " r.read(run))\n"
    ) % (str(root), ROOT, str(root), str(root / "BENCHMARK.json"), str(root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["two_view_arrays", "1", "castle-half", "['jobs_n.pair']", "2"]


@pytest.mark.parametrize("q,expect", [(50, 3.0), (90, 4.6)])
def test_job_quantiles(q, expect):
    run = harness.Run()
    run.job_s = [1.0, 2.0, 3.0, 4.0, 5.0]
    run.window_s = 15.0
    assert run.per_job_s() == 3.0
    assert run.job_quantile(q) == pytest.approx(expect)
