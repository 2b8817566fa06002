"""One run of one cell: set-up, the measured window, the traced extras,
the reference's check, and the result line.

Everything a cell needs is found by name: the cell in
``BENCHMARK.json``; its configuration's file (``configs[].file``); its
traffic mix ``sfmbench/workloads/<traffic>.json``, whose ``kind`` names
the generator ``sfmbench/traffic/<kind>.py``; and each metric's reader
``sfmbench/metrics/<metric>.py``.  A reader is a module with
``read(run)`` returning a number or None (nothing to read: the metric
is left out of the line), and optionally ``SPANS``, ``{span: [
"module:attribute", ...]}``, the program's functions that the traced run
wraps with ``torch.cuda.synchronize()`` on both sides to time the span.

A generator module has ``setup(ctx)`` -> state, ``job(ctx, state, i)``
(one job, ending in a synchronize, returning what the check needs),
``check(ctx, state, outputs)`` -> ``{number: (value, limit)}``,
``control(ctx, state, outputs)`` (the control's numbers, for
``control.py``), and optionally ``WARM_JOBS`` (set-up's jobs, 2 when
absent), ``profile_jobs(ctx, state, i)`` (a job under the profiler, whose
spans only label the idle gaps: no synchronize) and
``release(ctx, state)`` (undo set-up's wrappers before the check).
"""

from __future__ import annotations

import argparse
import functools
import importlib
import importlib.util
import inspect
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# top-level module names that may not be loaded in a run: the JAX
# package the port was made from, and JAX itself
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "spectavi_tpu")


def forbidden_loaded(modules=None):
    """Top-level names of loaded modules that the guard forbids,
    compared whole (``spectavi_tpu_torch`` is not ``spectavi_tpu``)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(n for n in names if n in FORBIDDEN_MODULES)


def process_age_s():
    """Seconds since this process started (the kernel's start time)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED_AT


_IMPORTED_AT = time.perf_counter()


def load_file(path, name=None):
    """Import the Python file ``path`` (its name may hold dots)."""
    name = name or "sfmbench_" + os.path.relpath(path, HERE).replace(os.sep, "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, traffic mix
    and metrics, all found by name."""

    def __init__(self, bench, name, root=ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(os.path.join(root, self.config_entry["file"]))
        self.traffic = load_json(os.path.join(HERE, "workloads", self.entry["traffic"] + ".json"))
        self.kind = self.traffic["kind"]
        self.chips = int(self.entry["chips"])
        e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        moved = {m["name"] for m in e2e}
        self.end_to_end = e2e
        self.per_layer = [
            m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)
        ]


def metric_reader(name):
    return load_file(os.path.join(HERE, "metrics", name + ".py"))


def generator_module(kind):
    return load_file(os.path.join(HERE, "traffic", kind + ".py"))


def resolve(target):
    """``"package.module:attr"`` -> ``(owner, attr)``."""
    mod_name, attr = target.split(":")
    owner = importlib.import_module(mod_name)
    if not hasattr(owner, attr):
        raise AttributeError(f"{mod_name} has no attribute {attr!r}")
    return owner, attr


class Patches:
    """Wrappers installed on the program's module attributes, undone on
    close."""

    def __init__(self):
        self._undo = []

    def wrap(self, target, make_wrapper):
        owner, attr = resolve(target)
        orig = getattr(owner, attr)
        setattr(owner, attr, make_wrapper(orig))
        self._undo.append((owner, attr, orig))

    def close(self):
        while self._undo:
            owner, attr, orig = self._undo.pop()
            setattr(owner, attr, orig)


class Spans:
    """Host-clock spans of wrapped functions, each bounded by device
    synchronisation, grouped by job: ``per_job[i][span]`` seconds and
    ``intervals`` ``(span, start, end)`` for labelling idle gaps."""

    def __init__(self, sync):
        self.sync = sync
        self.job = None
        self.per_job = []
        self.intervals = []

    def start_job(self):
        self.per_job.append({})
        self.job = self.per_job[-1]

    def wrapper(self, span):
        def make(fn):
            @functools.wraps(fn)
            def timed(*a, **k):
                self.sync()
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    self.sync()
                    t1 = time.perf_counter()
                    if self.job is not None:
                        self.job[span] = self.job.get(span, 0.0) + (t1 - t0)
                    self.intervals.append((span, t0, t1))
            return timed
        return make

    def mean(self, span, n_jobs):
        """Seconds a job of ``span``, over ``n_jobs`` jobs; None when no
        job ran it."""
        vals = [j.get(span) for j in self.per_job[:n_jobs]]
        if not any(v is not None for v in vals):
            return None
        return sum(v or 0.0 for v in vals) / max(len(vals), 1)


class Run:
    """What a run measured, handed to every metric reader."""

    def __init__(self):
        self.setup_s = None
        self.job_s = []
        self.window_s = None
        self.spans = None
        self.profile = None

    @property
    def jobs(self):
        return len(self.job_s)

    def per_job_s(self):
        return self.window_s / self.jobs if self.jobs else None

    def job_quantile(self, q):
        """The ``q``-th percentile of the window's job seconds."""
        if len(self.job_s) < 2:
            return None
        return statistics.quantiles(self.job_s, n=100, method="inclusive")[int(q) - 1]

    def roofline_pct(self):
        """Summed least time over summed device time of every K1, K2 and
        K3 launch in the profiled jobs, in percent; None without them."""
        p = self.profile
        if not p or sum(p["launches"].values()) == 0:
            return None
        device_s = sum(p["kernel_s"].values())
        return 100.0 * sum(p["bound_s"].values()) / device_s if device_s > 0 else None

    def idle_pct(self):
        """Share of the profiled jobs' wall time in which no device
        operation ran, in percent; None without a profile."""
        p = self.profile
        if not p or p["window_s"] <= 0:
            return None
        return 100.0 * (1.0 - p["busy_s"] / p["window_s"])


class Context:
    """A run's arguments and its cell, handed to the generator."""

    def __init__(self, cell, seed, seconds, trace, device):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device

    def job_seed(self, i):
        """The generator seed of job ``i`` (warm-up jobs: negative ``i``):
        drawn from ``--seed``, below 2**63."""
        import numpy as np

        return int(np.random.SeedSequence([self.seed & (2**63 - 1), i + 2**20]).generate_state(
            1, np.uint64)[0] >> np.uint64(1))

    def rng(self, stream):
        import numpy as np

        return np.random.default_rng([self.seed & (2**63 - 1), stream])


def _capture_launches(patches, store):
    """Record each kernel launch's arguments (for its bound) while the
    profiled jobs run."""
    from sfmbench.bounds import KERNELS

    for kname, (mod, attr, _) in KERNELS.items():
        def make(fn, kname=kname):
            sig = inspect.signature(fn)

            @functools.wraps(fn)
            def rec(*a, **k):
                bound = sig.bind(*a, **k)
                bound.apply_defaults()
                store.append((kname, tuple(bound.arguments.values())))
                return fn(*a, **k)
            return rec
        patches.wrap(f"{mod}:{attr}", make)


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile_window(run_jobs, torch, spans, device):
    """Run ``run_jobs()`` under ``torch.profiler`` (device activity
    only) and reduce the trace: device busy seconds (union of every
    device operation's interval), the window's host seconds, each
    kernel's launches with their bounds, device time by operation, and
    idle gaps labelled by the benchmark span they fall in."""
    from torch.profiler import ProfilerActivity, profile

    from sfmbench.bounds import KERNELS, launch_bound_ms

    launches = []
    patches = Patches()
    _capture_launches(patches, launches)
    torch.cuda.synchronize(device)
    mark = torch.zeros(1, device=device)
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize(device)
            t_mark = time.perf_counter()
            mark.add_(1.0)
            n = run_jobs()
            torch.cuda.synchronize(device)
            t_end = time.perf_counter()
    finally:
        patches.close()
    events = []
    for e in prof.profiler.kineto_results.events():
        if "cuda" not in str(e.device_type()).lower():
            continue
        s = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
        d = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000
        events.append((s, s + d, e.name()))
    if not events:
        return None
    events.sort()
    # the first device operation is the marker, launched right after
    # t_mark: it maps the trace's clock onto the host's
    offset = events[0][0] * 1e-9 - t_mark
    events = events[1:]
    lo = t_mark
    busy_iv = _union([(s * 1e-9 - offset, e * 1e-9 - offset) for s, e, _ in events])
    busy_s = sum(min(e, t_end) - max(s, lo) for s, e in busy_iv if e > lo and s < t_end)
    by_op = {}
    for s, e, name in events:
        key = name if len(name) <= 160 else name[:157] + "..."
        by_op[key] = by_op.get(key, 0.0) + (e - s) * 1e-9
    kernel_s = {k: sum((e - s) * 1e-9 for s, e, name in events if any(f in name for f in fns))
                for k, (_, _, fns) in KERNELS.items()}
    bound_s = {k: 0.0 for k in KERNELS}
    counts = {k: 0 for k in KERNELS}
    for kname, args in launches:
        bound_s[kname] += launch_bound_ms(kname, args) * 1e-3
        counts[kname] += 1
    gaps, t = [], lo
    for s, e in busy_iv:
        if s > t:
            gaps.append((t, min(s, t_end)))
        t = max(t, e)
    if t < t_end:
        gaps.append((t, t_end))
    idle = {}
    for s, e in gaps:
        if e <= s:
            continue
        mid = 0.5 * (s + e)
        inside = [(b - a, name) for name, a, b in spans.intervals if a <= mid <= b]
        label = min(inside)[1] if inside else "outside the spans"
        idle[label] = idle.get(label, 0.0) + (e - s)
    return {
        "jobs": n,
        "busy_s": busy_s,
        "window_s": t_end - lo,
        "kernel_s": kernel_s,
        "bound_s": bound_s,
        "launches": counts,
        "device_ops": sorted(([k, v] for k, v in by_op.items()), key=lambda r: -r[1])[:10],
        "idle_gaps": sorted(([k, v] for k, v in idle.items()), key=lambda r: -r[1])[:10],
    }


def device_info(torch, count):
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": count,
        "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(count)),
    }


def parse_args(argv):
    p = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(args, device="cuda", bench=None, out=sys.stdout, err=sys.stderr, cell=None):
    """Run one cell; returns ``(exit code, result dict or None)``.
    ``device="cpu"`` skips the look for a card, and ``cell`` stands in
    for the cell of ``BENCHMARK.json`` (tests only)."""
    import torch

    if cell is None:
        bench = bench or load_json(os.path.join(ROOT, "BENCHMARK.json"))
        cell = Cell(bench, args.workload)
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"needs {cell.chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=err)
            return 3, None
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)

        def sync():
            torch.cuda.synchronize(dev)
    else:
        dev = torch.device(device)

        def sync():
            pass

    # the reference's precision and the program's: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = Context(cell, args.seed, args.seconds, args.trace, dev)
    ctx.sync = sync
    gen = generator_module(cell.kind)
    metrics = cell.per_layer if args.trace else cell.end_to_end
    readers = {m["name"]: metric_reader(m["name"]) for m in metrics}
    run = Run()
    run.spans = Spans(sync)
    patches = Patches()

    state = gen.setup(ctx)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for i in range(getattr(gen, "WARM_JOBS", 2)):
        gen.job(ctx, state, -1 - i)
    sync()
    if args.trace:
        for r in readers.values():
            for span, targets in getattr(r, "SPANS", {}).items():
                for target in targets:
                    patches.wrap(target, run.spans.wrapper(span))
    run.setup_s = process_age_s()

    outputs = []
    attempted = failed = 0
    t_start = time.perf_counter()
    try:
        while time.perf_counter() - t_start < ctx.seconds:
            run.spans.start_job()
            attempted += 1
            t0 = time.perf_counter()
            try:
                outputs.append(gen.job(ctx, state, attempted - 1))
            except Exception as exc:  # a failed job is counted, and the run goes on
                failed += 1
                outputs.append(None)
                print(f"job {attempted - 1} failed: {exc!r}", file=err)
            sync()
            run.job_s.append(time.perf_counter() - t0)
        run.window_s = time.perf_counter() - t_start
        run.spans.job = None
    finally:
        patches.close()
    if args.trace and device == "cuda" and getattr(gen, "profile_jobs", None):
        # the profiled jobs run without the spans' synchronizes: the
        # same functions are wrapped only to note when the host is in
        # them, which labels the device's idle gaps
        labels = Spans(lambda: None)
        for r in readers.values():
            for span, targets in getattr(r, "SPANS", {}).items():
                for target in targets:
                    patches.wrap(target, labels.wrapper(span))

        def profiled():
            k = int(cell.traffic.get("profile_jobs", 1))
            for i in range(k):
                gen.profile_jobs(ctx, state, 10**6 + i)
            return k
        try:
            run.profile = profile_window(profiled, torch, labels, dev)
        finally:
            patches.close()
    dev_info = device_info(torch, cell.chips) if device == "cuda" else {
        "platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}

    # the program's device state goes before the reference runs
    state_keep = gen.release(ctx, state) if hasattr(gen, "release") else state
    if device == "cuda":
        torch.cuda.empty_cache()
    numbers = gen.check(ctx, state_keep, outputs)
    correct = failed == 0 and attempted > 0 and all(v <= lim for v, lim in numbers.values())

    values = {}
    for m in metrics:
        v = readers[m["name"]].read(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": values, "device": dev_info}
    if args.trace and run.profile is not None:
        result["device"]["busy_s"] = run.profile["busy_s"]
        result["device"]["window_s"] = run.profile["window_s"]
        result["breakdown"] = {"device_ops": run.profile["device_ops"],
                               "idle_gaps": run.profile["idle_gaps"]}
        print("kernels " + json.dumps({k: {"launches": run.profile["launches"][k],
                                             "device_s": run.profile["kernel_s"][k],
                                             "bound_s": run.profile["bound_s"][k]}
                                         for k in run.profile["launches"]}), file=err)
    print(f"jobs {run.jobs} in {run.window_s:.3f} s; job seconds {run.job_s}", file=err)
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in numbers.items()}

    bad = forbidden_loaded()
    if bad:
        print(f"forbidden modules loaded in the run: {bad}", file=err)
        return 4, None
    for k, (v, lim) in numbers.items():
        print(f"{k} {v!r} limit {lim!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0, result


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else argv)
    code, _ = run_cell(args)
    return code
