"""Weight gradient of the ResNet3D stem convolution: the plain version and
the kernel dispatch (counterpart of neraf_tpu/ops/pallas/stem_wgrad_kernel.py).

The port's stem is the direct conv3d, kernel 5, stride 2, padding 2, of the
batch-1 NDHWC grid volume x (1, D, H, W, cin) into cout channels. For the
cotangent g of its output, (1, cout, Do, Ho, Wo) as autograd gives it, the
weight gradient is

    dW[co, ci, kd, kh, kw] = sum_{d,h,w} g[co, d, h, w]
                             * x[2d+kd-2, 2h+kh-2, 2w+kw-2, ci]

with x zero outside the volume, in the (cout, cin, 5, 5, 5) layout of the
Conv3d weight. The JAX package computes the same function on the
space-to-depth folded volume (kernel 3, stride 1, 56 channels; the folded
tap i = 2 k + r, the 6th a zero pad).

``stem_wgrad`` runs the plain version for a CPU tensor and the hand-written
CUDA kernel (csrc/stem_wgrad.cu through ops/cuda/stem_wgrad.py) for a CUDA
tensor, with no fallback between them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

KERNEL, STRIDE, PAD = 5, 2, 2


def stem_wgrad_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x (1, D, H, W, cin), g (1, cout, Do, Ho, Wo) -> dW (cout, cin, 5, 5,
    5), summed in float32 (float64 for float64 inputs): the 125 taps one by
    one, each a strided slice of the zero-padded x contracted with g over
    the output voxels (the TPU kernel's 27-tap loop,
    neraf_tpu/ops/pallas/stem_wgrad_kernel.py:34-58). bf16 inputs are
    widened first: the product of two bf16 values is exact in float32."""
    acc = torch.promote_types(x.dtype, torch.float32)
    cout, do, ho, wo = g.shape[1:]
    xp = F.pad(x[0].permute(3, 0, 1, 2).to(acc), (PAD,) * 6)  # (cin, ...)
    gm = g[0].to(acc).reshape(cout, -1)
    dw = torch.empty((cout, x.shape[-1], KERNEL, KERNEL, KERNEL), dtype=acc,
                     device=x.device)
    for kd in range(KERNEL):
        for kh in range(KERNEL):
            for kw in range(KERNEL):
                xs = xp[:, kd:kd + STRIDE * do - 1:STRIDE,
                        kh:kh + STRIDE * ho - 1:STRIDE,
                        kw:kw + STRIDE * wo - 1:STRIDE]
                dw[:, :, kd, kh, kw] = gm @ xs.reshape(xs.shape[0], -1).T
    return dw


def stem_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The stem's weight gradient (cout, cin, 5, 5, 5), f32: the plain
    version for a CPU tensor, the CUDA kernel for a CUDA tensor (or it
    raises)."""
    if x.device.type == "cpu":
        return stem_wgrad_plain(x, g)
    from neraf_tpu_torch.ops.cuda.stem_wgrad import stem_wgrad_cuda

    return stem_wgrad_cuda(x, g)
