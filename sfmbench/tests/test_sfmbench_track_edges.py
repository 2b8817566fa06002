"""The reader of the program's ``track_edges`` counter
(``track_edges.sfm``): keypoint matches a job unions into tracks, on
synthetic records; nothing where the program keeps no such counter or
no tracer; and on a traced run of ``tum-seq10`` on the CPU, the matches
the job's pairs handed to track building."""

import io
import json

import pytest

from sfmbench import harness, program
from spectavi_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _tracer_restored():
    """Loading the reader turns the program's tracer on: put back the
    state each test found, with nothing recorded."""
    was = profiling.enabled()
    profiling.take()
    yield
    profiling.enable(was)
    profiling.take()


def _span(name, parent, job, start, end, **counts):
    return {"name": name, "parent": parent, "job": job, "start_ns": int(start * 1e9),
            "end_ns": int(end * 1e9), "counts": counts}


def _run(edges):
    """One warm job and the window's jobs, one a value of ``edges`` (None:
    not counted)."""
    spans = []
    for j, n in enumerate([1000] + list(edges)):
        t = 10.0 * j
        base = len(spans)
        spans += [_span("sfm", -1, j, t, t + 9.0),
                  _span("tracks", base, j, t + 3.0, t + 4.0,
                        **({} if n is None else {"track_edges": n}))]
    run = harness.Run()
    run.job_s = [9.0] * len(edges)
    run.window_s = 9.0 * len(edges)
    run.program = program.window_jobs(program.group_jobs(spans), run.jobs, 0)
    return run


@pytest.mark.parametrize("edges,expect", [
    ([812345, 812345], 812345.0),
    ([30000, 30002, 29998], 30000.0),
    ([None, None], None)])
def test_reads_the_mean_matches_a_job(edges, expect):
    got = harness.metric_reader("track_edges.sfm").read(_run(edges))
    assert got == (None if expect is None else pytest.approx(expect))


def test_reads_nothing_without_the_tracer(monkeypatch):
    monkeypatch.setattr(program, "_profiling", lambda: None)
    run = harness.Run()
    run.job_s = [1.0, 1.0]
    run.window_s = 2.0
    assert harness.metric_reader("track_edges.sfm").read(run) is None


def test_traced_run_on_the_cpu_reports_the_matches(tiny_bench, tiny):
    bench = tiny_bench(tiny)
    out, err = io.StringIO(), io.StringIO()
    args = harness.parse_args(["--workload", "tum-seq10", "--seed", "4294967311",
                               "--seconds", "1", "--trace", "1"])
    code, _ = harness.run_cell(args, device="cpu", bench=bench, out=out, err=err)
    assert code == 0
    value = json.loads(out.getvalue().strip().splitlines()[-1])["metrics"]["track_edges.sfm"]["value"]
    assert value > 0
    assert not profiling.enabled()
