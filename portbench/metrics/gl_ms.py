"""Device ms a request of the kernels launched under rir.griffin_lim:
Griffin-Lim on every channel of every RIR (dsp/griffin_lim.py, the kernel
of ops/cuda/griffin_lim.py launched through ctypes), from the traced
slice."""

from portbench.core.spans import device_ms

SOURCE = "program_span"


def read(rec):
    return device_ms(rec, "rir.griffin_lim") if "rirs" in rec.work else None
