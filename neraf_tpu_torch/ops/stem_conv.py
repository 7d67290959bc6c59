"""The ResNet3D stem convolution with the weight-gradient kernel as its
weight gradient (counterpart of neraf_tpu/ops/baked_stem.py).

Forward: conv3d, kernel 5, stride 2, padding 2, of the NDHWC volume through
F.conv3d, as the JAX package leaves its forward to XLA. Backward: the input
gradient from cuDNN's (aten.convolution_backward, only when x needs one),
over the whole volume: the JAX package's slab-local input VJP is not
ported, since cuDNN's full-volume input gradient is small on the card
(PERF.md); the weight gradient from ops/stem_wgrad.py::stem_wgrad, the
plain version on the CPU and the CUDA kernel on a card, never cuDNN's (the
kernel's wrapper pads the 7 grid channels to its 8).

Under autocast, x and the weight are cast to the autocast type before the
function, as autocast casts a conv's inputs: the weight gradient is summed
in float32, rounded to the weight's compute type (baked_stem.py:90,
.astype(wp.dtype)), and the cast's backward carries it to the float32
parameter. A float32 run stays in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from neraf_tpu_torch.ops.stem_wgrad import PAD, STRIDE, stem_wgrad


class StemConvFunction(torch.autograd.Function):
    """(1, D, H, W, cin) NDHWC x, (cout, cin, 5, 5, 5) weight -> the conv
    output (1, cout, Do, Ho, Wo). x and the weight share one dtype."""

    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x, weight)
        return F.conv3d(x.permute(0, 4, 1, 2, 3), weight, None, STRIDE, PAD)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.ops.aten.convolution_backward(
                g, x.permute(0, 4, 1, 2, 3), weight, None, (STRIDE,) * 3,
                (PAD,) * 3, (1,) * 3, False, (0,) * 3, 1,
                (True, False, False))[0].permute(0, 2, 3, 4, 1)
        if ctx.needs_input_grad[1]:
            dw = stem_wgrad(x, g).to(weight.dtype)
        return dx, dw


def stem_conv(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The stem conv of the NDHWC volume x through StemConvFunction, with
    autocast's casts made first."""
    dev = x.device.type
    if torch.is_autocast_enabled(dev):
        dtype = torch.get_autocast_dtype(dev)
        x, weight = x.to(dtype), weight.to(dtype)
    with torch.autocast(dev, enabled=False):
        return StemConvFunction.apply(x, weight)
