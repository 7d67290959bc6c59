"""Host ms of a request span, rir.request or image.request
(engine/pipeline.py), over the traced slice's units: the host's time to
launch a request's work, under the profiler."""

from portbench.core.spans import by_unit, request_host_ms

SOURCE = "program_span"


def read(rec):
    name = by_unit(rec, "rir.request", "image.request")
    return None if name is None else request_host_ms(rec, name)
