"""The program's spans against the device, for one cell.

    python3 sfmbench/program_trace.py --workload <cell> --seed <n>
        [--profile-jobs K] [--launches 0|1] [--cost-rounds R --cost-seconds S]

After the cell's set-up and warm jobs, on one CUDA card:

* ``--profile-jobs K``: K jobs through ``harness.profile_window``, as
  the harness runs its profiled jobs (the readers' ``SPANS`` wrapped
  without a synchronize, the program's tracer on), with the program's
  spans among the labels of the idle gaps: each gap goes to the
  innermost span open at its midpoint, the harness's rule.  Gives the
  ten largest labels, the share of idle time that no program span
  names (outside the spans, or a job root's own time), and the
  ``spans`` table with those labels' idle seconds;
* ``--launches 1``: one job under ``torch.profiler`` with host
  activity: each kernel launch (the runtime's launch call) given to the
  innermost program span open around it on the profiler's own clock;
* ``--cost-rounds R``: windows of ``--cost-seconds`` with the program's
  tracer off and on in turns (off, on, on, off, ...), each a closed
  loop of jobs as the benchmark's window: seconds a job of each.

Prints one JSON line; ``--out FILE`` also writes it there.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Labels:
    """The benchmark's span intervals plus the program's spans, which
    are taken from the tracer when ``profile_window`` first reads
    ``intervals``, after its jobs have run."""

    def __init__(self, spans, profiling, program):
        self._spans = spans
        self._profiling = profiling
        self._program = program
        self._all = None
        self.jobs = None

    @property
    def intervals(self):
        if self._all is None:
            rec = self._profiling.take()
            self.jobs = [j for j in self._program.group_jobs(rec["spans"])
                         if j["name"] in self._program.ROOTS]
            self._all = self._spans.intervals + self._program.intervals(self.jobs)
        return self._all


def profiled(run_job, k, torch, dev, profiling, harness, program, cell):
    """``k`` jobs through ``harness.profile_window`` with the program's
    spans among the labels."""
    base = harness.Spans(lambda: None)
    patches = harness.Patches()
    for m in cell.per_layer:
        for span, targets in getattr(harness.metric_reader(m["name"]), "SPANS", {}).items():
            for target in targets:
                patches.wrap(target, base.wrapper(span))
    labels = Labels(base, profiling, program)
    profiling.enable()
    profiling.take()

    def run_jobs():
        for _ in range(k):
            run_job()
        return k
    try:
        prof = harness.profile_window(run_jobs, torch, labels, dev)
    finally:
        patches.close()
    labels.intervals  # the program's spans, where the window held no idle gap
    idle_s = prof["window_s"] - prof["busy_s"]
    top = dict(prof["idle_gaps"])
    unnamed = top.get(program.OUTSIDE, 0.0) + sum(top.get(r, 0.0) for r in program.ROOTS)
    return {"jobs": prof["jobs"], "window_s": prof["window_s"], "busy_s": prof["busy_s"],
            "idle_s": idle_s, "idle_pct": 100.0 * idle_s / prof["window_s"],
            "idle_gaps": prof["idle_gaps"],
            "idle_unnamed_share": unnamed / idle_s if idle_s > 0 else None,
            "spans": program.span_table(labels.jobs, idle=top)}


def _ns(e, which):
    if hasattr(e, which + "_ns"):
        return getattr(e, which + "_ns")()
    return getattr(e, which + "_us")() * 1000


def launches(run_job, torch, dev, profiling, program):
    """Kernel launches of one job by the innermost program span open
    around each, on the profiler's host clock."""
    from torch.profiler import ProfilerActivity, profile

    profiling.enable()
    profiling.take()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_job()
        torch.cuda.synchronize(dev)
    names = {s["name"] for s in profiling.take()["spans"]}
    marks = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if "cuda" in str(e.device_type()).lower():
            continue
        start = _ns(e, "start")
        if name in names:
            marks.append((start, 0, start + _ns(e, "duration"), name))
        elif "LaunchKernel" in name:
            marks.append((start, 1, None, None))
    marks.sort(key=lambda m: m[:2])
    out, open_spans = {}, []
    for t, kind, end, name in marks:
        while open_spans and open_spans[-1][0] < t:
            open_spans.pop()
        if kind == 0:
            open_spans.append((end, name))
        else:
            label = open_spans[-1][1] if open_spans else program.OUTSIDE
            out[label] = out.get(label, 0) + 1
    return sorted(([k, v] for k, v in out.items()), key=lambda r: -r[1])


def cost(run_job, rounds, seconds, profiling, torch, dev):
    """Windows with the tracer off and on in turns: seconds a job."""
    out = []
    order = []
    for r in range(rounds):
        order += [False, True] if r % 2 == 0 else [True, False]
    for on in order:
        profiling.enable(on)
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            run_job()
            torch.cuda.synchronize(dev)
            n += 1
        window = time.perf_counter() - t0
        profiling.disable()
        profiling.take()
        out.append({"tracing": on, "jobs": n, "per_job_s": window / n})
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--profile-jobs", type=int, default=0)
    p.add_argument("--launches", type=int, choices=(0, 1), default=0)
    p.add_argument("--cost-rounds", type=int, default=0)
    p.add_argument("--cost-seconds", type=float, default=20.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    build = os.path.join(ROOT, "build")
    os.environ.setdefault("SPECTAVI_TORCH_BUILD_DIR", os.path.join(build, "kernels"))
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from sfmbench import harness, program
    from spectavi_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.Cell(harness.load_json(os.path.join(ROOT, "BENCHMARK.json")), args.workload)
    ctx = harness.Context(cell, args.seed, args.cost_seconds, 1, dev)
    ctx.sync = lambda: torch.cuda.synchronize(dev)
    gen = harness.generator_module(cell.kind)
    state = gen.setup(ctx)
    profiling.disable()
    for i in range(getattr(gen, "WARM_JOBS", 2)):
        gen.job(ctx, state, -1 - i)
    counter = iter(range(10**6, 2 * 10**6))

    def run_job():
        gen.profile_jobs(ctx, state, next(counter))

    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(0)}
    if args.profile_jobs:
        out["profile"] = profiled(run_job, args.profile_jobs, torch, dev, profiling, harness,
                                  program, cell)
    if args.launches:
        out["launches"] = launches(run_job, torch, dev, profiling, program)
    if args.cost_rounds:
        out["cost"] = cost(run_job, args.cost_rounds, args.cost_seconds, profiling, torch, dev)
    profiling.disable()
    if hasattr(gen, "release"):
        gen.release(ctx, state)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
