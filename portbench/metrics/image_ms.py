"""The window over the images completed inside it, in ms."""

SOURCE = "host_clock"


def read(rec):
    if "pixels" not in rec.work or rec.units <= 0:
        return None
    return 1e3 * rec.seconds / rec.units
