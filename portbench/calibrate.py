#!/usr/bin/env python3
"""The readings that a cell's limits for `correct` are set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 [--control fp8] [--seconds 3]

runs the cell once a seed, in one process, and prints a JSON line a seed
with every number compared: with --control, the control (the reference in
float8 e4m3, the precision below the configuration's bfloat16, put in the
program's place; no window is run); without it, sound runs of the program
with a short window. The benchmark's own runs never run the control.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv) -> int:
    import torch

    from portbench.core import spec as bench
    from portbench.core.common import Run

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default=None, choices=(None, "fp8"))
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = bench.resolve(args.workload)
    from neraf_tpu_torch.ops.cuda import build

    build.load()
    drive = bench.kind(cell.traffic["kind"]).drive
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = Run(cell=cell.name, spec=cell.config["model"], traffic=cell.traffic,
                  limits=cell.limits, seed=seed, seconds=args.seconds, trace=False,
                  device=torch.device("cuda", 0), started=t0, control=args.control)
        torch.cuda.reset_peak_memory_stats()
        out = drive(run)
        print(json.dumps({"workload": cell.name, "seed": seed, "control": args.control,
                          "readings": out.readings,
                          "correct": out.correct, "units": out.record.units,
                          "seconds": time.perf_counter() - t0, "notes": out.notes}), flush=True)
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
