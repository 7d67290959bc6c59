"""RIRs of the requests completed inside the window, over its seconds."""

SOURCE = "host_clock"


def read(rec):
    if "rirs" not in rec.work:
        return None
    return rec.units * rec.work["rirs"] / rec.seconds
