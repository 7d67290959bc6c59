"""Device ms a unit of the kernels of the 3D ResNet's convolutions,
BatchNorms and max pool (models/resnet3d.py, ops/baked_stem.py), from the
traced slice."""

SOURCE = "device_trace"

# the CPU ops under which they launch their kernels, forward and backward
RESNET_OPS = ("aten::convolution", "aten::convolution_backward",
              "aten::native_batch_norm", "aten::native_batch_norm_backward",
              "aten::cudnn_batch_norm", "aten::cudnn_batch_norm_backward",
              "aten::max_pool3d_with_indices", "aten::max_pool3d_with_indices_backward")


def read(rec):
    t = rec.trace
    if t is None or t.units <= 0:
        return None
    ms = sum(t.under_ms.get(op, 0.0) for op in RESNET_OPS)
    return ms / t.units if ms > 0 else None
