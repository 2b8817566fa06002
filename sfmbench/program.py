"""The program's own spans and counters, for the readers that read them.

``spectavi_tpu_torch.utils.profiling`` records, while it is on, each
span of the program as ``(name, parent, job, start_ns, end_ns)`` on the
host's ``perf_counter`` clock, with each span's share of the counters:
``ransac_trials``, and on a CUDA card ``host_sync``, the synchronizing
operations the runtime reports from the program's code.  The harness
loads per-layer readers only in a traced run, and the readers of those
numbers (``host_syncs.*``, ``ransac_trials.*``, ``tracks_s.sfm``) call
:func:`enable` when they are loaded, so the tracer is on for the whole
traced run: set-up's warm jobs, the window's jobs, the profiled jobs,
until the first of them reads.

:func:`collect` takes the records once, after the run, and keeps the
window's jobs as ``run.program``: a list, one entry a job, of ``{"name":
root span, "spans": [span dicts], "counts": {counter: n}}``.  The
window's jobs are the last ``run.jobs`` job roots (``two_view``,
``sfm``) before the profiled jobs (``run.profile["jobs"]``).  It also
prints one ``spans`` line on standard error: for each span name, calls,
seconds, self seconds (less its children) and ``host_sync`` count per
job.  A harness that sets ``run.program`` itself is read as it is.

A program without the tracer (no ``enable`` / ``take``) gives no
records: every reader then returns None and the metric is left out.
"""

from __future__ import annotations

import json
import sys

ROOTS = ("two_view", "sfm")
# the harness's label of an idle gap that no span holds
OUTSIDE = "outside the spans"


def _profiling():
    try:
        from spectavi_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not (callable(getattr(profiling, "enable", None))
            and callable(getattr(profiling, "take", None))):
        return None
    return profiling


def enable():
    """Turn the program's tracer on; False where the program has none."""
    profiling = _profiling()
    if profiling is None:
        return False
    profiling.enable()
    return True


def group_jobs(spans):
    """Records of ``profiling.take()["spans"]`` -> one entry a job id,
    in the order the jobs started: ``{"name", "spans", "counts"}``, the
    name that of the job's first span (its root), each span with its
    ``index`` in ``spans``, the counts summed over the job's spans."""
    jobs = {}
    for i, s in enumerate(spans):
        job = jobs.setdefault(s["job"], {"name": s["name"], "spans": [], "counts": {}})
        job["spans"].append(dict(s, index=i))
        for k, v in (s.get("counts") or {}).items():
            job["counts"][k] = job["counts"].get(k, 0) + v
    return list(jobs.values())


def window_jobs(jobs, n_window, n_profiled):
    """The ``n_window`` job roots before the last ``n_profiled``; None
    where the records hold fewer."""
    roots = [j for j in jobs if j["name"] in ROOTS]
    if n_window <= 0 or len(roots) < n_window + n_profiled:
        return None
    end = len(roots) - n_profiled
    return roots[end - n_window:end]


def collect(run):
    """``run.program``: the window's jobs (see the module's notes), or
    None without records.  Takes the program's records on its first
    call, turns the tracer off, and prints the ``spans`` line."""
    if hasattr(run, "program"):
        return run.program
    run.program = None
    profiling = _profiling()
    if profiling is None:
        return None
    profiling.disable()
    rec = profiling.take()
    n_profiled = int(run.profile["jobs"]) if getattr(run, "profile", None) else 0
    run.program = window_jobs(group_jobs(rec["spans"]), run.jobs, n_profiled)
    if run.program:
        print("spans " + json.dumps(span_table(run.program)), file=sys.stderr)
    return run.program


def seconds(span):
    if span["end_ns"] is None:
        return 0.0
    return (span["end_ns"] - span["start_ns"]) * 1e-9


def span_seconds(job, names):
    """Seconds of the job's spans named in ``names``."""
    return sum(seconds(s) for s in job["spans"] if s["name"] in names)


def job_mean(run, value):
    """Mean over the window's jobs of ``value(job)``; None without
    records."""
    jobs = collect(run)
    if not jobs:
        return None
    return sum(value(j) for j in jobs) / len(jobs)


def counter_mean(run, name):
    return job_mean(run, lambda j: j["counts"].get(name, 0))


def span_table(jobs, idle=None):
    """For each span name, per job: ``calls``, ``s`` (seconds), ``self_s``
    (less the seconds of its direct children), ``host_sync`` (its own
    count), and, given ``idle`` (``{name: seconds}`` over the same
    jobs), ``idle_s``."""
    table = {}
    for job in jobs:
        spans = job["spans"]
        pos = {s["index"]: i for i, s in enumerate(spans)}
        child_s = [0.0] * len(spans)
        for s in spans:
            if s["parent"] in pos:
                child_s[pos[s["parent"]]] += seconds(s)
        for s, c in zip(spans, child_s):
            row = table.setdefault(s["name"], {"calls": 0, "s": 0.0, "self_s": 0.0,
                                               "host_sync": 0})
            row["calls"] += 1
            row["s"] += seconds(s)
            row["self_s"] += seconds(s) - c
            row["host_sync"] += (s.get("counts") or {}).get("host_sync", 0)
    n = max(len(jobs), 1)
    for name, row in table.items():
        for k in row:
            row[k] /= n
        if idle is not None:
            row["idle_s"] = idle.get(name, 0.0) / n
    return table


def intervals(jobs):
    """``(name, start, end)`` of every span of ``jobs``, in seconds of
    ``time.perf_counter()``, for labelling idle gaps."""
    return [(s["name"], s["start_ns"] * 1e-9, s["end_ns"] * 1e-9)
            for j in jobs for s in j["spans"] if s["end_ns"] is not None]
