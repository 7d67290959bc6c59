"""Seconds from the process start to the window: building the kernels where
none are built, the program, its weights and inputs, and the warm-up."""

SOURCE = "host_clock"


def read(rec):
    return rec.setup_s
