"""Device ms an image of the kernels launched under vision.sampler: the
uniform bins, each PDF resampling and the samples of each set of bins
(ops/samplers.py), from the traced slice."""

from portbench.core.spans import device_ms

SOURCE = "program_span"


def read(rec):
    return device_ms(rec, "vision.sampler") if "pixels" in rec.work else None
