"""The readings that the limits of ``correct`` are set from.

    python3 sfmbench/control.py --workload <cell> --seeds 11,12,13 --seconds 8

For each seed, in one process: the cell's set-up, a window of the
cell's own jobs at its own sizes, then the compared numbers twice: the
program's answers against the reference (the lower readings), and the
control's, the reference put in the program's place a precision below
the configuration's (the upper readings).  One JSON line a seed on
standard output.  The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell_name, seeds, seconds, device="cuda", bench=None, out=sys.stdout):
    import torch

    from sfmbench import harness

    bench = bench or harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = harness.Cell(bench, cell_name)
    gen = harness.generator_module(cell.kind)
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for seed in seeds:
        ctx = harness.Context(cell, seed, seconds, 0, dev)
        ctx.sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
        st = gen.setup(ctx)
        for i in range(getattr(gen, "WARM_JOBS", 2)):
            gen.job(ctx, st, -1 - i)
        outputs, t0 = [], time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            outputs.append(gen.job(ctx, st, len(outputs)))
        st = gen.release(ctx, st) if hasattr(gen, "release") else st
        limits = cell.config["limits"]
        sound = {k: v for k, (v, _) in gen.check(ctx, st, outputs).items()}
        ctl = gen.control(ctx, st, outputs)
        row = {"workload": cell_name, "seed": seed, "jobs": len(outputs),
               "program": sound, "control": ctl,
               "control_fails": sorted(k for k, v in ctl.items() if v > limits[k]),
               "program_fails": sorted(k for k, v in sound.items() if v > limits[k])}
        print(json.dumps(row), file=out, flush=True)
        rows.append(row)
        del st, outputs
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=8.0)
    a = p.parse_args()
    readings(a.workload, [int(s) for s in a.seeds.split(",")], a.seconds)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
