"""Profiling and tracing helpers.

Port of ``spectavi_tpu/utils/profiling.py``:

* :class:`spectavi_tpu_torch.pipeline.io.Timer` — per-step wall clock;
* :func:`trace` — a ``torch.profiler`` trace of the enclosed block (host
  operations and, on a CUDA machine, the device's kernels), written as a
  Chrome / TensorBoard trace file;
* :func:`annotate` — a named span on the profiler's timeline, and an
  NVTX range on CUDA.
"""

from __future__ import annotations

import contextlib
import os
import tempfile

import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler


@contextlib.contextmanager
def trace(logdir=None):
    """Profile the enclosed block and write its trace
    (``*.pt.trace.json``) into ``logdir`` (by default
    ``spectavi_tpu_torch_profile`` under the temporary directory).

    Open it in ``chrome://tracing`` / Perfetto, or with TensorBoard's
    profiler plugin: ``tensorboard --logdir <logdir>``.  Yields the
    ``torch.profiler.profile`` object."""
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "spectavi_tpu_torch_profile")
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


@contextlib.contextmanager
def annotate(name):
    """Named span that shows up on the profiler timeline (and, on a
    CUDA machine, as an NVTX range)."""
    with record_function(name):
        if not torch.cuda.is_available():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()
