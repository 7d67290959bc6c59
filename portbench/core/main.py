"""One run of one cell: look for the card, drive the cell's traffic (its
kind's loop), read the metrics the cell reports with their readers, and
print the result.

Standard error ends with the numbers compared for `correct`, each beside
its limit; standard output ends with the result line, whose last key,
`checks`, holds them again.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

from portbench.core import spec as bench

FORBIDDEN = {"jax", "jaxlib", "flax", "neraf_tpu"}


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (neraf_tpu_torch is not neraf_tpu)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def card_report(device) -> str:
    import torch

    if device.type != "cuda":
        return f"device {device} (no card)"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi unavailable ({e})"
    return f"card {torch.cuda.get_device_name(device)}; nvidia-smi: {smi}"


def main(argv, started: float) -> int:
    args = parse(argv)
    cell = bench.resolve(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, {torch.cuda.device_count()} present",
              file=sys.stderr)
        return 2
    from portbench.core.common import Run

    run = Run(cell=cell.name, spec=cell.config["model"], traffic=cell.traffic,
              limits=cell.limits, seed=args.seed, seconds=args.seconds,
              trace=bool(args.trace), device=torch.device("cuda", 0), started=started)
    return execute(run, cell)


def execute(run, cell, out=None, err=None) -> int:
    """Drive the run and print its result; the tests call it on the CPU."""
    import torch

    out, err = out or sys.stdout, err or sys.stderr
    print(card_report(run.device), file=err, flush=True)
    if run.device.type == "cuda":
        # the port's kernel library, built once into build/neraf_tpu_torch/
        # before any thread can ask for it
        from neraf_tpu_torch.ops.cuda import build

        build.load()
    outcome = bench.kind(run.traffic["kind"]).drive(run)
    rec = outcome.record
    metrics = {}
    for m in (cell.per_layer if run.trace else cell.end_to_end):
        value = bench.metric_reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = run.device.type == "cuda"
    device = {"platform": "gpu" if cuda else run.device.type,
              "kind": torch.cuda.get_device_name(run.device) if cuda else "cpu",
              "count": cell.chips, "memory_peak_bytes": outcome.memory_peak}
    result = {"correct": outcome.correct, "attempted": rec.units, "failed": 0,
              "metrics": metrics, "device": device}
    if run.trace and rec.trace is not None:
        device["busy_s"] = rec.trace.busy_s
        device["window_s"] = rec.trace.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in rec.trace.device_ops()],
                               "idle_gaps": [list(x) for x in rec.trace.gaps]}
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in outcome.checks}
    bad = forbidden_modules()
    if bad:
        print(f"refusing to report: JAX or the JAX package is loaded: {bad}", file=err)
        return 3
    for note in outcome.notes:
        print(note, file=err)
    for name, v, lim in outcome.checks:
        print(f"check {name} = {v!r} (limit {lim!r})", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0
