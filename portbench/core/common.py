"""What every traffic kind shares: the run's context, the record the metric
readers read, and the outcome the result line is printed from."""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from portbench.core.trace import Trace


@dataclass
class Run:
    """One run of a cell. `spec` is the configuration's "model" section;
    `control` puts the reference in the program's place at that precision
    (portbench/calibrate.py)."""
    cell: str
    spec: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    started: float
    control: str | None = None

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@dataclass
class Record:
    """What a run measured, for the metric readers: the units of work
    (requests) completed in the window of `seconds`, their latencies, the
    traced slice, and `work`, what one unit holds as its kind counts it
    from the configuration's shapes: "flops" (model FLOPs), and where the
    unit has them "rirs", "pixels", and the least ms of a kernel's work,
    "<kernel>_bound_ms". A reader finds nothing to read where its key is
    absent."""
    seconds: float
    units: int
    latencies_s: list
    setup_s: float
    work: dict
    trace: Trace | None = None


@dataclass
class Outcome:
    record: Record
    checks: list          # [(name, value, limit)]
    memory_peak: int
    notes: list = field(default_factory=list)
    readings: dict = field(default_factory=dict)  # every number compared, limit or none

    @property
    def correct(self) -> bool:
        return all(math.isfinite(v) and v <= lim for _, v, lim in self.checks)
