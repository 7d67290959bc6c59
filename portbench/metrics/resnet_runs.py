"""ResNet runs a RIR request (counters rir.grid_features / rir.requests,
over the whole run): the scene descriptor does not depend on the request,
so each run past one a grid is work a cache would save."""

from portbench.core.spans import counter

SOURCE = "program_counter"


def read(rec):
    if "rirs" not in rec.work:
        return None
    runs, requests = counter("rir.grid_features"), counter("rir.requests")
    if not runs or not requests:
        return None
    return runs / requests
