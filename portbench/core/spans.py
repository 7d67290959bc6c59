"""What the program's tracer (neraf_tpu_torch/utils/profiling.py) gives the
per-layer readers (portbench/metrics/*.py): the device ms of the kernels
launched under one of its spans in the traced slice, the host ms of its
request spans there, and its counters. A span is a profiler range
"neraf.<name>", the cpu_parent of the ops and kernel launches made
inside it, so the traced slice's `under_ms` holds it. A program without
the tracer, or a run without the span or counter, gives None, never an
error."""

from __future__ import annotations

PREFIX = "neraf."  # the tracer's profiler ranges are named PREFIX + span


def device_ms(rec, name: str):
    """Device ms a unit of the kernels launched under the span `name`."""
    t = rec.trace
    if t is None or t.units <= 0:
        return None
    ms = t.under_ms.get(PREFIX + name, 0.0)
    return ms / t.units if ms > 0 else None


def by_unit(rec, rir: str, image: str):
    """The span of a unit's kind: `rir` where a unit holds RIRs, `image`
    where it holds pixels, else None."""
    if "rirs" in rec.work:
        return rir
    return image if "pixels" in rec.work else None


def request_host_ms(rec, name: str):
    """Mean host ms of the program's last spans `name`, one a unit of the
    traced slice (the spans it stores are those the profiler saw: the
    slice's)."""
    try:
        from neraf_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    t = rec.trace
    if t is None or t.units <= 0:
        return None
    got = [s["host_ms"] for s in spans() if s["name"] == name][-t.units:]
    return sum(got) / len(got) if got else None


def counter(name: str):
    """The program's counter `name`, or None."""
    try:
        from neraf_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    return counters().get(name)
