"""Device ms a request of the kernels launched under rir.grid_feature: the
scene grid's volume through the eval ResNet (models/resnet3d.py), from the
traced slice."""

from portbench.core.spans import device_ms

SOURCE = "program_span"


def read(rec):
    return device_ms(rec, "rir.grid_feature") if "rirs" in rec.work else None
