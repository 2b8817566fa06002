"""The program's tracer: spans, counters and ``torch.profiler`` traces.

Port of ``spectavi_tpu/utils/profiling.py``, grown into the port's one
tracer:

* :func:`step` — a step-level span that always reads the host clock
  (two ``perf_counter_ns`` calls); the pipelines' ``*_seconds`` and
  :class:`spectavi_tpu_torch.pipeline.io.Timer` read it;
* :func:`annotate` — a named span; off, one shared no-op context;
* :func:`count` — add to a named counter (``ransac_trials``,
  ``sampson_scored``); off, it returns at once;
* :func:`enable` / :func:`disable` / :func:`take` — turn recording on
  and off, and hand back what was recorded;
* :func:`trace` — a ``torch.profiler`` trace of the enclosed block
  (host operations and, on a CUDA machine, the device's kernels),
  written as a Chrome / TensorBoard trace file, with recording on so
  that the spans appear beside the kernels.

Tracing is off by default.  On, each span records ``(name, parent
index, job id, start_ns, end_ns)`` on ``time.perf_counter_ns()`` (the
clock of ``time.perf_counter()``) and opens ``record_function(name)``
and, on a CUDA machine, an NVTX range.  The job id is that of the
outermost open span (``two_view``, ``sfm``, ``cli``), shared by every
span inside it.  A count goes to its counter and to the innermost open
span's share of it.

On a CUDA machine, recording also turns on the runtime's report of
synchronizing operations (``torch.cuda.set_sync_debug_mode("warn")``)
and counts each one that the program's own code issues as
``host_sync``: a read of a device tensor (``.cpu()``, ``.tolist()``,
``.item()``), a shape-dependent op (``nonzero``, boolean indexing), a
copy of a pageable host array to the device, cuSOLVER's status reads.
The count is the runtime's, not a list kept in the code; a CPU run
counts none, since nothing waits there.  Reports issued by code outside
the package (a caller's own ``torch.cuda.synchronize()``) are left out.

A span never synchronizes: it is host time.  A step that ends in a
host read of a device result (``.cpu()``, ``.tolist()``) is complete
when its span ends; a step that only enqueues device work is not, and
the device time it queued lands in the span of the next host read.
One thread records at a time.
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys
import tempfile
import warnings
from time import perf_counter_ns

import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler

# the counter of points where the host waits on the device, as the CUDA
# runtime reports them
HOST_SYNC = "host_sync"
_SYNC_REPORT = "called a synchronizing CUDA operation"
_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep
_TORCH = os.path.dirname(os.path.abspath(torch.__file__)) + os.sep
# the counter of hypotheses whose Sampson counts the CUDA kernel gave
# (``ops/sampson.py``), from host shapes: a CPU run counts none
SAMPSON_SCORED = "sampson_scored"

_on = False
_nvtx = False
_records = []  # spans in the order they opened, since the last take()
_stack = []  # open recorded spans, innermost last
_counters = {}
_jobs = 0
_epoch = 0  # take() count: a parent taken away is no parent
_watch = None  # (warnings context, previous sync debug mode) while syncs are counted


class Span:
    """A host-clock interval; recorded (and shown on the profiler's
    timeline) while tracing is on.  ``elapsed`` is its seconds once it
    has ended."""

    __slots__ = ("name", "start_ns", "end_ns", "_rec", "parent", "job", "counts", "_epoch",
                 "_index", "_range")

    def __init__(self, name, rec):
        self.name = name
        self.start_ns = self.end_ns = None
        self._rec = rec

    def __enter__(self):
        if self._rec:
            _open(self)
        self.start_ns = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = perf_counter_ns()
        if self._rec:
            _close(self)
        return False

    @property
    def elapsed(self):
        if self.end_ns is None:
            return None
        return (self.end_ns - self.start_ns) * 1e-9


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


def _open(span):
    global _jobs
    parent = _stack[-1] if _stack else None
    if parent is None:
        span.job = _jobs
        _jobs += 1
    else:
        span.job = parent.job
    span.parent = parent._index if parent is not None and parent._epoch == _epoch else -1
    span.counts = None
    span._epoch = _epoch
    span._index = len(_records)
    _records.append(span)
    _stack.append(span)
    span._range = record_function(span.name)
    span._range.__enter__()
    if _nvtx:
        torch.cuda.nvtx.range_push(span.name)


def _close(span):
    if _nvtx:
        torch.cuda.nvtx.range_pop()
    span._range.__exit__(None, None, None)
    span._range = None
    if _stack and _stack[-1] is span:
        _stack.pop()
    elif span in _stack:
        _stack.remove(span)


def enable(on=True):
    """Turn recording on (or off with ``on=False``); returns whether it
    was on."""
    global _on, _nvtx
    was = _on
    _on = bool(on)
    _nvtx = _on and torch.cuda.is_available()
    _watch_syncs(_nvtx)
    return was


def _from_program(frame):
    """Whether the innermost frame outside ``warnings`` and ``torch``
    belongs to this package."""
    while frame is not None:
        path = frame.f_code.co_filename
        if not (path.startswith(_TORCH) or path == warnings.__file__):
            return path.startswith(_PACKAGE)
        frame = frame.f_back
    return False


def _watch_syncs(on):
    """Count the runtime's reports of synchronizing operations as
    ``host_sync`` (``on``), or stop and restore the warnings state and
    the debug mode."""
    global _watch
    if on == (_watch is not None):
        return
    if not on:
        ctx, mode = _watch
        _watch = None
        torch.cuda.set_sync_debug_mode(mode)
        ctx.__exit__(None, None, None)
        return
    ctx = warnings.catch_warnings()
    ctx.__enter__()
    warnings.filterwarnings("always", message=_SYNC_REPORT)
    shown = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        if not str(message).startswith(_SYNC_REPORT):
            shown(message, category, filename, lineno, file, line)
        elif _from_program(sys._getframe(1)):
            count(HOST_SYNC)

    warnings.showwarning = show
    _watch = (ctx, torch.cuda.get_sync_debug_mode())
    torch.cuda.set_sync_debug_mode("warn")


def disable():
    """Turn recording off; returns whether it was on."""
    return enable(False)


def enabled():
    return _on


def step(name):
    """A step-level span: always timed (``elapsed``), recorded only
    while tracing is on."""
    return Span(name, _on)


def annotate(name):
    """Named span that shows up on the profiler timeline (and, on a
    CUDA machine, as an NVTX range) while tracing is on; off, the one
    shared no-op context."""
    return Span(name, True) if _on else _NOOP


def spanned(name):
    """Decorator: the function's calls run inside ``annotate(name)``."""
    def deco(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)
        return inner
    return deco


def count(name, n=1):
    """Add ``n`` to counter ``name`` and to the innermost open span's
    share of it (tracing on; off, nothing)."""
    if not _on:
        return
    _counters[name] = _counters.get(name, 0) + n
    if _stack:
        span = _stack[-1]
        if span.counts is None:
            span.counts = {}
        span.counts[name] = span.counts.get(name, 0) + n


def take():
    """The spans and counters recorded since the last call, which are
    then cleared: ``{"spans": [{"name", "parent", "job", "start_ns",
    "end_ns", "counts"}, ...], "counters": {name: n}}``.  ``parent`` is
    an index into ``spans`` (-1 for none); a span still open has
    ``end_ns`` None."""
    global _records, _counters, _epoch
    spans = [{"name": s.name, "parent": s.parent, "job": s.job, "start_ns": s.start_ns,
              "end_ns": s.end_ns, "counts": dict(s.counts or {})} for s in _records]
    counters = _counters
    _records, _counters = [], {}
    _epoch += 1
    return {"spans": spans, "counters": counters}


@contextlib.contextmanager
def trace(logdir=None):
    """Profile the enclosed block and write its trace
    (``*.pt.trace.json``) into ``logdir`` (by default
    ``spectavi_tpu_torch_profile`` under the temporary directory), with
    span recording on inside it (:func:`take` hands the spans back).

    Open it in ``chrome://tracing`` / Perfetto, or with TensorBoard's
    profiler plugin: ``tensorboard --logdir <logdir>``.  Yields the
    ``torch.profiler.profile`` object."""
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "spectavi_tpu_torch_profile")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    was = enable()
    try:
        with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
            yield prof
    finally:
        enable(was)
