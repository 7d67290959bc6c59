"""% of the traced slice in which no operation ran on the card."""

SOURCE = "device_trace"


def read(rec):
    t = rec.trace
    if t is None or t.window_s <= 0 or not t.kernels:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
