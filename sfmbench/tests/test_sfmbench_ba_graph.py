"""The reader of the program's ``ba_graph_iters`` counter
(``ba_graph_iters.sfm``): LM iterations a job ran as CUDA-graph replays,
on synthetic records; 0 where no BA counted any (a CPU run, a program
without the graph path); nothing without the tracer."""

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


def _run(graph_iters):
    """One warm job and the window's jobs, one a value of ``graph_iters``
    as ``(final BA, local BA)`` counts (None: not counted)."""
    spans = []
    for j, iters in enumerate([(15, 8)] + list(graph_iters)):
        t = 10.0 * j
        base = len(spans)
        final, local = iters or (None, None)
        spans += [_span("sfm", -1, j, t, t + 9.0),
                  _span("graph", base, j, t + 1.0, t + 4.0),
                  _span("graph.local_ba", base + 1, j, t + 2.0, t + 3.0,
                        **({} if local is None else {"ba_graph_iters": local})),
                  _span("ba", base, j, t + 5.0, t + 6.0),
                  _span("ba.iterate", base + 3, j, t + 5.1, t + 5.9,
                        **({} if final is None else {"ba_graph_iters": final}))]
    run = harness.Run()
    run.job_s = [9.0] * len(graph_iters)
    run.window_s = 9.0 * len(graph_iters)
    run.program = program.window_jobs(program.group_jobs(spans), run.jobs, 0)
    return run


@pytest.mark.parametrize("graph_iters,expect", [
    ([(15, 8), (15, 8), (15, 16)], (23 + 23 + 31) / 3),
    ([None, None], 0.0)])
def test_reads_the_mean_replays_a_job(graph_iters, expect):
    run = _run(graph_iters)
    assert harness.metric_reader("ba_graph_iters.sfm").read(run) == pytest.approx(expect)


def test_reads_nothing_without_the_tracer(monkeypatch):
    monkeypatch.setattr(program, "_profiling", lambda: None)
    run = harness.Run()
    run.job_s = [1.0, 1.0]
    run.window_s = 2.0
    assert harness.metric_reader("ba_graph_iters.sfm").read(run) is None
