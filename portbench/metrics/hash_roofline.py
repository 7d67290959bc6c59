"""% of the least time of a unit's hash-encoding forward (the main field's
samples; ops/cuda/hash_encoding.py) in the device time of its kernel. The
bound leaves out the table rows read, so the share is a floor."""

from portbench.core.readers import kernel_share

SOURCE = "device_trace"


def read(rec):
    return kernel_share(rec, rec.work.get("hash_bound_ms"),
                        lambda name: "hash_encoding_fwd" in name)
