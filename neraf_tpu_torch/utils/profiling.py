"""Profiling: torch.profiler traces and section timers (counterpart of
neraf_tpu/utils/profiling.py).

The reference's nerfstudio @profiler.time_function layer
(NeRAF_pipeline.py:166,231,261,291): a context manager that writes a Chrome
trace (chrome://tracing, Perfetto) of the host and, on a card, its device
kernels; and a section timer whose averages can go into the metrics
stream.

The JAX package's utils/cache.py (the persistent XLA compilation cache) has
no counterpart: the port compiles no XLA. Its CUDA kernels are built once
into build/neraf_tpu_torch/ (ops/cuda/build.py) and reused from there.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """torch.profiler around a block (CPU, and CUDA when a card is
    present) -> log_dir/trace.json, a Chrome trace. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


class SectionTimer:
    """Accumulating wall-clock timer: timer.section('name') contexts."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict:
        return {f"{k}_ms": 1e3 * self.totals[k] / max(self.counts[k], 1)
                for k in self.totals}
