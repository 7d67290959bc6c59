"""Device ms an image of the kernels launched under vision.render: the
main weights, colour, accumulation, both depths and the clamp
(ops/render.py), from the traced slice."""

from portbench.core.spans import device_ms

SOURCE = "program_span"


def read(rec):
    return device_ms(rec, "vision.render") if "pixels" in rec.work else None
