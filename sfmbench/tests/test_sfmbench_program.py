"""The readers of the program's own spans and counters
(``sfmbench/program.py`` and the five metrics that use it), on
synthetic records and on a traced run of each kind on the CPU; the
labels of ``sfmbench/program_trace.py`` through the harness's
``profile_window``; the runtime's sync reports on a card."""

import io
import json
import time
import types

import pytest
import torch

from sfmbench import harness, program, program_trace
from spectavi_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _tracer_restored():
    """Loading a reader turns the program's tracer on: put back the
    state each test found, with nothing recorded."""
    was = profiling.enabled()
    profiling.take()
    yield
    profiling.enable(was)
    profiling.take()

READERS = ("host_syncs.pair", "host_syncs.sfm", "ransac_trials.pair", "ransac_trials.sfm",
           "tracks_s.sfm")


def _span(name, parent, job, start, end, **counts):
    return {"name": name, "parent": parent, "job": job, "start_ns": int(start * 1e9),
            "end_ns": int(end * 1e9), "counts": counts}


def _records(root, n_jobs, t0=0.0):
    """``n_jobs`` jobs of ``root``, 10 s apart: a tracks span of 1 s, a
    triangulate span of 0.5 s with 3 syncs, a pair step with 4096
    trials and 2 syncs."""
    spans = []
    for j in range(n_jobs):
        t = t0 + 10.0 * j
        base = len(spans)
        spans += [_span(root, -1, j, t, t + 9.0),
                  _span("pairs", base, j, t + 1.0, t + 3.0, host_sync=2),
                  _span("pairs.ransac", base + 1, j, t + 1.5, t + 2.5, ransac_trials=4096 * (j + 1)),
                  _span("tracks", base, j, t + 3.0, t + 4.0),
                  _span("triangulate", base, j, t + 4.0, t + 4.5, host_sync=3)]
    return spans


def _run(n_window, n_warm=2, n_profiled=0, root="sfm"):
    run = harness.Run()
    run.job_s = [9.0] * n_window
    run.window_s = 9.0 * n_window
    if n_profiled:
        run.profile = {"jobs": n_profiled}
    spans = _records(root, n_warm + n_window + n_profiled)
    jobs = program.group_jobs(spans)
    run.program = program.window_jobs(jobs, run.jobs, n_profiled)
    return run


@pytest.mark.parametrize("name,expect", [
    ("host_syncs.pair", 5.0), ("host_syncs.sfm", 5.0), ("ransac_trials.pair", 4096 * 4.0),
    ("ransac_trials.sfm", 4096 * 4.0), ("tracks_s.sfm", 1.5)])
def test_readers_read_a_synthetic_program(name, expect):
    # 2 warm jobs, 3 in the window (trials 3, 4, 5 x 4096), 1 profiled
    run = _run(3, n_warm=2, n_profiled=1)
    assert [j["counts"]["ransac_trials"] for j in run.program] == [4096 * k for k in (3, 4, 5)]
    assert harness.metric_reader(name).read(run) == pytest.approx(expect)


def test_readers_read_nothing_without_the_tracer(monkeypatch):
    monkeypatch.setattr(program, "_profiling", lambda: None)
    assert program.enable() is False
    for name in READERS:
        run = harness.Run()
        run.job_s = [1.0, 1.0]
        run.window_s = 2.0
        assert harness.metric_reader(name).read(run) is None


def test_too_few_records_read_nothing():
    jobs = program.group_jobs(_records("two_view", 3))
    assert program.window_jobs(jobs, 3, 1) is None
    assert program.window_jobs(jobs, 0, 0) is None
    assert len(program.window_jobs(jobs, 2, 1)) == 2


def test_span_table_self_seconds_and_syncs():
    jobs = program.group_jobs(_records("sfm", 2))
    table = program.span_table(jobs, idle={"tracks": 0.4})
    assert table["sfm"]["calls"] == 1.0
    assert table["sfm"]["self_s"] == pytest.approx(9.0 - 2.0 - 1.0 - 0.5)
    assert table["pairs"]["self_s"] == pytest.approx(1.0)
    assert table["triangulate"]["host_sync"] == 3.0
    assert table["tracks"]["idle_s"] == pytest.approx(0.2)
    assert table["pairs"]["idle_s"] == 0.0


class _Event:
    def __init__(self, start, end, name="kernel", device="DeviceType.CUDA"):
        self._s, self._e, self._name, self._dev = start, end, name, device

    def name(self):
        return self._name

    def device_type(self):
        return self._dev

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s


def _fake_profiler(monkeypatch, events):
    """``torch.profiler.profile`` replaced by one whose trace holds
    ``events`` (filled while the profiled block runs)."""
    class Profile:
        def __init__(self, activities=None):
            self.profiler = types.SimpleNamespace(
                kineto_results=types.SimpleNamespace(events=lambda: list(events)))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    return types.SimpleNamespace(cuda=types.SimpleNamespace(synchronize=lambda *a: None),
                                 zeros=torch.zeros)


def _idle_run(monkeypatch, program_spans):
    """One job under ``profile_window``, the device busy but for a gap
    of 10 ms in each of four stretches: inside the program's
    ``pairs.batch`` within the benchmark's ``pairs`` span, inside
    ``pairs`` alone, inside the job root alone, and after the job.
    Returns ``profile_window``'s idle gaps with ``program_trace``'s
    labels and with the benchmark's spans alone."""
    events = []
    fake_torch = _fake_profiler(monkeypatch, events)
    base = harness.Spans(lambda: None)
    stretches = []

    def hold():
        t0 = time.perf_counter_ns()
        time.sleep(0.03)
        stretches.append((t0, time.perf_counter_ns()))

    def pair_step():
        with profiling.annotate("pairs.batch"):
            hold()
        hold()
    wrapped = base.wrapper("pairs")(pair_step)

    def run_jobs():
        events.clear()
        stretches.clear()
        events.append(_Event(time.perf_counter_ns(), time.perf_counter_ns() + 1000))
        with profiling.annotate("sfm"):
            wrapped()
            hold()
        hold()
        # busy everywhere but the middle 10 ms of each stretch
        t = events[0]._s
        for s, e in stretches:
            mid = (s + e) // 2
            events.append(_Event(t, mid - 5_000_000))
            t = mid + 5_000_000
        events.append(_Event(t, time.perf_counter_ns() + 10**9))
        return 1

    profiling.enable(program_spans)
    profiling.take()
    labels = program_trace.Labels(base, profiling, program)
    ours = dict(harness.profile_window(run_jobs, fake_torch, labels, "cpu")["idle_gaps"])
    theirs = dict(harness.profile_window(run_jobs, fake_torch, base, "cpu")["idle_gaps"])
    return ours, theirs


def test_gap_labels_take_the_innermost_span(monkeypatch):
    # the harness's span wraps the step; the program's spans nest inside
    ours, _ = _idle_run(monkeypatch, True)
    assert ours == pytest.approx({"pairs.batch": 0.01, "pairs": 0.01, "sfm": 0.01,
                                  program.OUTSIDE: 0.01})


def test_without_program_spans_the_labels_are_the_harness_spans(monkeypatch):
    ours, theirs = _idle_run(monkeypatch, False)
    assert theirs == pytest.approx({"pairs": 0.02, program.OUTSIDE: 0.02})
    assert ours == pytest.approx(theirs)


@pytest.mark.parametrize("cell,names", [
    ("castle-pair", {"host_syncs.pair", "ransac_trials.pair"}),
    ("tum-seq10", {"host_syncs.sfm", "ransac_trials.sfm", "tracks_s.sfm"})])
def test_traced_run_on_the_cpu_reports_the_program_metrics(tiny_bench, tiny, cell, names):
    bench = tiny_bench(tiny)
    out, err = io.StringIO(), io.StringIO()
    args = harness.parse_args(["--workload", cell, "--seed", "4294967311", "--seconds", "1",
                               "--trace", "1"])
    code, res = harness.run_cell(args, device="cpu", bench=bench, out=out, err=err)
    assert code == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert names <= set(line["metrics"])
    for name in names - {"host_syncs.pair", "host_syncs.sfm"}:
        assert line["metrics"][name]["value"] > 0, name
    # nothing waits on the CPU: the runtime reports no synchronization
    for name in names & {"host_syncs.pair", "host_syncs.sfm"}:
        assert line["metrics"][name]["value"] == 0, name
    # the readers turn the tracer off once they have read it
    assert not profiling.enabled()
    if cell == "castle-pair":
        # step 3's fitter scores whole blocks of 8192 trials
        assert line["metrics"]["ransac_trials.pair"]["value"] % 8192 == 0


def test_launches_go_to_the_innermost_program_span(monkeypatch):
    def ev(start, end, name, device="DeviceType.CPU"):
        return _Event(start, end, name, device)

    events = [ev(0, 100, "sfm"), ev(10, 40, "pairs.ransac"), ev(12, 13, "cudaLaunchKernel"),
              ev(20, 21, "cuLaunchKernel"), ev(45, 46, "cudaLaunchKernel"),
              ev(50, 60, "aten::add"), ev(55, 56, "cudaLaunchKernel"),
              ev(200, 201, "cudaLaunchKernel"),
              # the device's copy of an annotation, and a kernel: not launches
              ev(30, 90, "sfm", "DeviceType.CUDA"), ev(15, 16, "void k()", "DeviceType.CUDA")]
    fake_torch = _fake_profiler(monkeypatch, events)

    def run_job():
        with profiling.annotate("sfm"):
            with profiling.annotate("pairs.ransac"):
                pass

    got = program_trace.launches(run_job, fake_torch, "cpu", profiling, program)
    assert got == [["pairs.ransac", 2], ["sfm", 2], [program.OUTSIDE, 1]]


@pytest.mark.card
def test_sync_reports_on_the_card_count_the_program_only(card, monkeypatch):
    import os

    x = torch.arange(8.0, device=card)
    profiling.enable()
    profiling.take()
    try:
        # this file stands in for the program's code
        monkeypatch.setattr(profiling, "_PACKAGE", os.path.dirname(os.path.abspath(__file__)))
        with profiling.annotate("reads"):
            x.cpu()
            (x > 3).nonzero()
            x.sum().item()
        monkeypatch.undo()
        with profiling.annotate("outside"):
            torch.cuda.synchronize(card)
            x.cpu()
    finally:
        profiling.disable()
    counts = {s["name"]: s["counts"] for s in profiling.take()["spans"]}
    assert counts == {"reads": {"host_sync": 3}, "outside": {}}
