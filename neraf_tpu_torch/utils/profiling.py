"""The port's tracer (counterpart of neraf_tpu/utils/profiling.py): spans at
the stage boundaries of the RIR request, the image chunk and the train
step, counters beside them, and the Chrome-trace exporter.

span(name) names a stage. While nothing records, it returns one shared
null context: a flag check, no clock read, no allocation. It records
while a torch.profiler is recording (the span is then also a range
"neraf.<name>" on the profiler's own clock, the cpu_parent of the aten ops
made inside it; a function-scope record, as an aten op is, so that a
kernel launched through ctypes directly inside it is linked to it, which
a record_function range, of user scope, is not) or inside
recording() (then, with a card present, also a CUDA event at each end, so
that spans() gives the span's device ms without the profiler). A record
holds the name, its id, its parent's id (a stack per thread), the id of
the request it belongs to and its host start and end
(time.perf_counter_ns); the store keeps the newest STORE_SIZE. request(kind)
is a span that takes a fresh request id, which every span under it
carries.

count(name, n) is always on. trace(log_dir) is the one exporter: a
Chrome trace, the spans and the counters of the block.

The JAX package's utils/cache.py (the persistent XLA compilation cache) has
no counterpart: the port compiles no XLA. Its CUDA kernels are built once
into build/neraf_tpu_torch/ (ops/cuda/build.py) and reused from there.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import threading
import time
from pathlib import Path

import torch
from torch.autograd import profiler as _autograd_profiler

PREFIX = "neraf."  # a span's profiler range is named PREFIX + its name
STORE_SIZE = 100_000

_NULL = contextlib.nullcontext()
_store: collections.deque = collections.deque(maxlen=STORE_SIZE)
_ids = itertools.count(1)  # span and request ids, one sequence
_local = threading.local()  # .stack: the thread's open span records
_counts: dict = {}
_counts_lock = threading.Lock()
_recording = 0  # depth of open recording() blocks
_cuda_events = False  # whether those blocks time spans on the card


class _Span:
    """A span that records (span() hands one out only while something
    records)."""

    __slots__ = ("name", "new_request", "rec", "rf", "events")

    def __init__(self, name: str, new_request: bool):
        self.name, self.new_request = name, new_request

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        parent = stack[-1] if stack else None
        if self.new_request:
            request = next(_ids)
        else:
            request = None if parent is None else parent["request"]
        self.rec = rec = {"name": self.name, "id": next(_ids),
                          "parent": None if parent is None else parent["id"],
                          "request": request, "thread": threading.get_ident()}
        self.rf = None
        if _autograd_profiler._is_profiler_enabled:
            self.rf = torch._C._profiler._RecordFunctionFast(PREFIX + self.name)
            self.rf.__enter__()
        self.events = None
        if _recording and _cuda_events:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        stack.append(rec)
        rec["start_ns"] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec["end_ns"] = time.perf_counter_ns()
        _local.stack.pop()
        if self.events is not None:
            self.events[1].record()
            rec["_events"] = self.events
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _store.append(rec)
        return False


def span(name: str):
    """A context naming a stage (module docstring)."""
    if _recording or _autograd_profiler._is_profiler_enabled:
        return _Span(name, False)
    return _NULL


def request(kind: str):
    """A span that starts a request: every span under it carries its id."""
    if _recording or _autograd_profiler._is_profiler_enabled:
        return _Span(kind, True)
    return _NULL


@contextlib.contextmanager
def recording():
    """Record spans without a profiler; with a card present, time each on
    it with a CUDA event at each end (spans() gives device_ms)."""
    global _recording, _cuda_events
    cuda = _cuda_events
    _recording += 1
    _cuda_events = torch.cuda.is_available()
    try:
        yield
    finally:
        _recording -= 1
        _cuda_events = cuda


def spans() -> list:
    """The stored span records, oldest first: name, id, parent, request,
    thread, start_ns, end_ns, host_ms, and device_ms for a span timed on
    the card (recording() waits for its end here)."""
    out = []
    for rec in list(_store):
        events = rec.pop("_events", None)
        if events is not None:
            events[1].synchronize()
            rec["device_ms"] = events[0].elapsed_time(events[1])
        out.append({**rec, "host_ms": (rec["end_ns"] - rec["start_ns"]) / 1e6})
    return out


def clear() -> None:
    """Empty the span store."""
    _store.clear()


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name`."""
    with _counts_lock:
        _counts[name] = _counts.get(name, 0) + n


def counters() -> dict:
    """Every counter's value since the last reset_counters()."""
    with _counts_lock:
        return dict(_counts)


def reset_counters() -> None:
    with _counts_lock:
        _counts.clear()


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """torch.profiler around a block (CPU, and CUDA when a card is present)
    -> log_dir/trace.json, a Chrome trace with the spans as ranges;
    log_dir/spans.jsonl, one line a span recorded in the block; and
    log_dir/counters.json, what each counter counted in it. Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    first, before = next(_ids), counters()
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))
    with open(log_dir / "spans.jsonl", "w") as f:
        for rec in spans():
            if rec["id"] > first:
                f.write(json.dumps(rec) + "\n")
    counted = {k: v - before.get(k, 0) for k, v in counters().items()
               if v != before.get(k, 0)}
    (log_dir / "counters.json").write_text(json.dumps(counted, indent=1) + "\n")
