"""The small CPU sizes the harness's tests run at: for RIRs a small audio
model (resnet18, a 32-wide field output, 12 frames) over a 16^3 grid, for
images the full-width vision model on 16 x 16 views (a view's rays are
what a CPU cannot hold, not the model), and small traffic. The program is
built from these numbers as from a configuration file."""

from __future__ import annotations

import copy
import json
import time

import torch

from portbench.core import spec as bench
from portbench.core.common import Run

TINY_MODEL = {
    "rir": {"audio": {"max_len": 12, "w_field": 32, "resnet": "resnet18", "grid_res": 16}},
    "image": {},
}
TINY_TRAFFIC = {
    "rir": {"rirs_per_request": 3, "clients": 2, "warm_requests": 1, "traced_requests": 1,
            "check_requests": 1, "check_pool": 2},
    "image": {"height": 16, "width": 16, "camera_pool": 8, "clients": 2, "warm_requests": 1,
              "traced_requests": 1, "check_requests": 1, "check_pool": 2},
}


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) else v
    return out


def tiny_run(cell_name: str, seed: int = 1, seconds: float = 5.0, trace: bool = False,
             mixed_precision: bool = False, control: str | None = None,
             limits: dict | None = None):
    """(Run, Cell) of `cell_name` at the tiny sizes, on the CPU, with two
    threads (test workers share the host's cores)."""
    torch.set_num_threads(min(2, torch.get_num_threads()))
    cell = bench.resolve(cell_name)
    kind = cell.traffic["kind"]
    model = _merge(cell.config["model"], TINY_MODEL[kind])
    model["mixed_precision"] = mixed_precision
    traffic = _merge(cell.traffic, TINY_TRAFFIC[kind])
    run = Run(cell=cell_name, spec=model, traffic=traffic,
              limits=dict(cell.limits if limits is None else limits), seed=seed,
              seconds=seconds, trace=trace, device=torch.device("cpu"),
              started=time.perf_counter(), control=control)
    return run, cell


def result_of(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])
