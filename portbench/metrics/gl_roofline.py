"""% of the least time of a unit's Griffin-Lim (32 iterations on every
channel of every RIR; dsp/griffin_lim.py, ops/cuda/griffin_lim.py) in the
device time of the Griffin-Lim kernel."""

from portbench.core.readers import kernel_share

SOURCE = "device_trace"


def read(rec):
    return kernel_share(rec, rec.work.get("gl_bound_ms"), lambda name: "griffin_lim" in name)
