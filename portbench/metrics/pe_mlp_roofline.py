"""% of the least time of a unit's PE+MLP work (ops/cuda/pe_mlp.py: both
proposal fields, and the main field where it is fourier) in the device
time of the pe_mlp kernels."""

from portbench.core.readers import kernel_share

SOURCE = "device_trace"


def read(rec):
    return kernel_share(rec, rec.work.get("pe_mlp_bound_ms"), lambda name: "pe_mlp" in name)
