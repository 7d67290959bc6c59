"""The benchmark's data: BENCHMARK.json and the files it names by name.

A cell (an entry of `workloads`) names a configuration, whose file is
given in `configs`, and a traffic mix, portbench/traffic/<traffic>.json,
whose "kind" names the module that drives it, portbench/kinds/<kind>.py;
its limits for `correct` are portbench/limits/<cell>.json; each metric
that the cell reports has its reader in portbench/metrics/<metric>.py or,
for a metric named <quantity>.<part>, where that file is absent, in
portbench/metrics/<quantity>.py. Adding a configuration, a mix, a kind, a
cell or a metric adds files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def applies(metric: dict, cell: str) -> bool:
    """Whether a metric is reported in a cell: listed there, or listed
    nowhere."""
    return "workloads" not in metric or cell in metric["workloads"]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration's file
    traffic: dict         # portbench/traffic/<traffic>.json
    limits: dict          # portbench/limits/<cell>.json
    end_to_end: list      # the metric entries of BENCHMARK.json it reports
    per_layer: list


def resolve(cell: str, root: Path = ROOT) -> Cell:
    """Everything a run of `cell` reads, found by name; KeyError for a cell
    the benchmark does not have."""
    bench = load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if cell not in work:
        raise KeyError(f"no workload {cell!r}; the benchmark has {sorted(work)}")
    w = work[cell]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=cell, chips=w["chips"],
        config=json.loads((root / cfg["file"]).read_text()),
        traffic=json.loads((root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((root / "portbench" / "limits" / f"{cell}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, cell)],
        per_layer=[m for m in bench["per_layer"] if applies(m, cell)])


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT):
    """The reader of a metric: SOURCE and read(record)."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = path.with_name(name.rsplit(".", 1)[0] + ".py")
    return _module(path, f"portbench_metric_{name}")


def kind(name: str, root: Path = ROOT):
    """The module that drives a traffic kind: drive(run) -> Outcome."""
    return _module(root / "portbench" / "kinds" / f"{name}.py", f"portbench_kind_{name}")
