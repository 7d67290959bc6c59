"""A traced slice of a run: torch.profiler over a fixed amount of work,
reduced to what the per-layer readers and the result's breakdown need.

The slice runs outside the measured window, so the profiler's cost to the
host never reaches an end-to-end metric.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch


@dataclass
class Trace:
    window_s: float                 # host seconds from the slice's start to its end
    units: int                      # steps, requests or images inside it
    kernels: list                   # [(name, start_us, end_us)] of the device's operations
    under_ms: dict                  # {CPU op name: device ms of the kernels launched under it}
    gaps: list = field(default_factory=list)  # [(what the host did, seconds)]

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device: the union of
        their intervals."""
        total, end = 0.0, float("-inf")
        for a, b in sorted((s, e) for _, s, e in self.kernels):
            if b > end:
                total += b - max(a, end)
                end = b
        return total / 1e6

    def kernel_ms(self, match) -> float:
        """Device ms of the operations whose name satisfies match(name)."""
        return sum(e - s for n, s, e in self.kernels if match(n)) / 1e3

    def device_ops(self, n: int = 10) -> list:
        tot = {}
        for name, s, e in self.kernels:
            tot[name[:120]] = tot.get(name[:120], 0.0) + (e - s) / 1e6
        return sorted(tot.items(), key=lambda kv: -kv[1])[:n]


def _host_op(cpu, t: float) -> str:
    """The innermost CPU op running at time t (us), or 'host idle'."""
    best = None
    for s, e, name in cpu:
        if s > t:
            break
        if e >= t and (best is None or s >= best[0]):
            best = (s, name)
    return best[1] if best else "no op on the host"


def capture(fn, synchronize) -> Trace:
    """Profile fn() (which returns the units of work it did) on CPU and
    CUDA and reduce the trace."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        units = fn()
        synchronize()
        window = time.perf_counter() - t0
    events = prof.events()
    kernels, under, cpu = [], {}, []
    for e in events:
        if e.device_type.name == "CUDA":
            # a record_function range is mirrored on the device's timeline
            # as an annotation that spans kernels: no operation of its own
            if getattr(e, "is_user_annotation", False):
                continue
            if e.time_range.end > e.time_range.start:
                kernels.append((e.name, e.time_range.start, e.time_range.end))
            continue
        cpu.append((e.time_range.start, e.time_range.end, e.name))
        ks = getattr(e, "kernels", None) or []
        ms = sum(k.duration for k in ks) / 1e3
        if ms <= 0:
            continue
        names, p = set(), e
        while p is not None:
            names.add(p.name)
            p = p.cpu_parent
        for n in names:
            under[n] = under.get(n, 0.0) + ms
    cpu.sort()
    spans = sorted((s, e) for _, s, e in kernels)
    holes, end = [], None
    for s, e in spans:
        if end is not None and s > end:
            holes.append((s - end, end, s))
        end = e if end is None else max(end, e)
    holes.sort(reverse=True)
    gaps = [(_host_op(cpu, (a + b) / 2), g / 1e6) for g, a, b in holes[:10]]
    return Trace(window_s=window, units=units, kernels=kernels, under_ms=under, gaps=gaps)
