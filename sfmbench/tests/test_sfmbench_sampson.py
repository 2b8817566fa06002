"""The reader of the program's ``sampson_scored`` counter
(``sampson_scored.sfm``): hypotheses a job scored in the Sampson counting
kernel, on synthetic records; 0 where no launch counted any (a CPU run,
a program without the kernel); nothing without the tracer.  Then the
counter itself on a CPU run of the program: 0."""

import numpy as np
import pytest
import torch

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


def _run(scored):
    """One warm job and the window's jobs, one a value of ``scored`` as
    ``(pair step, retried pairs)`` counts (None: not counted)."""
    spans = []
    for j, counts in enumerate([(24576 * 9, None)] + list(scored)):
        t = 10.0 * j
        base = len(spans)
        batch, retry = counts or (None, None)
        spans += [_span("sfm", -1, j, t, t + 9.0),
                  _span("pairs", base, j, t + 1.0, t + 4.0),
                  _span("pairs.ransac", base + 1, j, t + 1.5, t + 2.5,
                        **({} if batch is None else {"sampson_scored": batch})),
                  _span("pairs.retry", base + 1, j, t + 3.0, t + 3.5,
                        **({} if retry is None else {"sampson_scored": retry}))]
    run = harness.Run()
    run.job_s = [9.0] * len(scored)
    run.window_s = 9.0 * len(scored)
    run.program = program.window_jobs(program.group_jobs(spans), run.jobs, 0)
    return run


@pytest.mark.parametrize("scored,expect", [
    ([(1351680, None), (1351680, None)], 1351680.0),
    ([(221184, None), (221184, 6144 * 2), (221184, None)], 221184 + 6144 * 2 / 3),
    ([None, None], 0.0)])
def test_reads_the_mean_hypotheses_a_job(scored, expect):
    run = _run(scored)
    assert harness.metric_reader("sampson_scored.sfm").read(run) == pytest.approx(expect)


def test_reads_nothing_without_the_tracer(monkeypatch):
    monkeypatch.setattr(program, "_profiling", lambda: None)
    run = harness.Run()
    run.job_s = [1.0, 1.0]
    run.window_s = 2.0
    assert harness.metric_reader("sampson_scored.sfm").read(run) is None


def test_the_counter_reads_zero_on_the_cpu():
    from spectavi_tpu_torch.mvg import ransac

    rng = np.random.default_rng(0)
    x0 = torch.as_tensor(rng.uniform(-0.5, 0.5, (2, 64, 2)), dtype=torch.float32)
    x1 = x0 + torch.as_tensor(1e-3 * rng.standard_normal((2, 64, 2)), dtype=torch.float32)
    profiling.enable()
    with profiling.annotate("pairs.ransac"):
        ransac.ransac_essential_core(torch.Generator().manual_seed(1), x0, x1, 32, 3.35e-4, 1e-3)
    rec = profiling.take()
    assert rec["counters"].get(profiling.SAMPSON_SCORED, 0) == 0
    assert rec["counters"].get("host_sync", 0) == 0
