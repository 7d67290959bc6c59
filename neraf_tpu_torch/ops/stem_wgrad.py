"""Weight gradient of the ResNet3D stem convolution: the plain versions,
the weight fold and the kernel dispatch (counterpart of
neraf_tpu/ops/pallas/stem_wgrad_kernel.py).

The stem is conv3d, kernel 5, stride 2, padding 2, of the batch-1 NDHWC
grid volume x (1, D, H, W, cin) into cout channels, with its weight in the
(cout, cin, 5, 5, 5) layout of a Conv3d. On an even-sided volume it runs
space-to-depth folded (models/grid.py::fold_volume, as the JAX package's
stem does): a conv3d, kernel 3, stride 1, padding 1, of the folded volume
xf (1, D/2, H/2, W/2, 8 cin) with the folded weight (fold_weight: kernel
tap i = 2 k + r, r the position in the 2^3 block, the padded 6th tap
zero). For the cotangent g (1, cout, D/2, H/2, W/2) of its output, the
TPU kernel computes the folded conv's weight gradient

    dWf[k, c8, co] = sum_{d,h,w} g[co, d, h, w] xf[(d, h, w) + k - 1, c8]

(xf zero outside the volume), k over 3^3 taps, which is the direct conv's
weight gradient up to the fold: stem_wgrad_unfold drops the padded taps and
returns (cout, cin, 5, 5, 5).

``stem_wgrad`` takes the folded volume and returns the Conv3d-layout
weight gradient: the plain version for a CPU tensor and the hand-written
CUDA kernel (csrc/stem_wgrad.cu through ops/cuda/stem_wgrad.py) for a CUDA
tensor, with no fallback between them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

KERNEL, STRIDE, PAD = 5, 2, 2


def fold_weight(w: torch.Tensor) -> torch.Tensor:
    """Direct stem weight (cout, cin, 5, 5, 5) -> the folded conv's (cout,
    8 cin, 3, 3, 3): each tap padded to 6, i = 2 k + r, the input channels
    in fold_volume's (rd, rh, rw, c) order (neraf_tpu/models/resnet3d.py:
    123-127 in the Conv3d layout)."""
    cout, cin = w.shape[:2]
    wp = F.pad(w, (0, 1, 0, 1, 0, 1))
    wp = wp.reshape(cout, cin, 3, 2, 3, 2, 3, 2)
    return wp.permute(0, 3, 5, 7, 1, 2, 4, 6).reshape(cout, 8 * cin, 3, 3, 3)


def unfold_weight(wp: torch.Tensor) -> torch.Tensor:
    """The transpose of fold_weight: (cout, 8 cin, 3, 3, 3) -> (cout, cin,
    5, 5, 5), the padded 6th tap of each axis dropped."""
    cout, c8 = wp.shape[:2]
    w = wp.reshape(cout, 2, 2, 2, c8 // 8, 3, 3, 3)
    w = w.permute(0, 4, 5, 1, 6, 2, 7, 3).reshape(cout, c8 // 8, 6, 6, 6)
    return w[:, :, :KERNEL, :KERNEL, :KERNEL]


def stem_wgrad_unfold(dwf: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's (3, 3, 3, 8 cin, cout) folded weight gradient ->
    the Conv3d weight's (cout, cin, 5, 5, 5)."""
    return unfold_weight(dwf.permute(4, 3, 0, 1, 2))


def stem_wgrad_folded_plain(xf: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """xf (1, D, H, W, C8) folded, g (1, cout, D, H, W) -> dWf (3, 3, 3, C8,
    cout), summed in float32 (float64 for float64 inputs): the TPU kernel's
    27-tap loop (neraf_tpu/ops/pallas/stem_wgrad_kernel.py:34-58), each tap
    a shifted slice of the zero-padded xf contracted with g over the
    voxels. bf16 inputs are widened first: the product of two bf16 values
    is exact in float32."""
    acc = torch.promote_types(xf.dtype, torch.float32)
    c8, cout = xf.shape[-1], g.shape[1]
    D, H, W = xf.shape[1:4]
    xp = F.pad(xf[0].permute(3, 0, 1, 2).to(acc), (1,) * 6)  # (C8, ...)
    gm = g[0].to(acc).reshape(cout, -1)
    dw = torch.empty((3, 3, 3, c8, cout), dtype=acc, device=xf.device)
    for kd in range(3):
        for kh in range(3):
            for kw in range(3):
                xs = xp[:, kd:kd + D, kh:kh + H, kw:kw + W].reshape(c8, -1)
                dw[kd, kh, kw] = xs @ gm.T
    return dw


def stem_wgrad_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The direct conv's weight gradient, an independent reference: x (1,
    D, H, W, cin), g (1, cout, Do, Ho, Wo) -> dW (cout, cin, 5, 5, 5),
    summed in float32 (float64 for float64 inputs), the 125 taps one by
    one, each a strided slice of the zero-padded x contracted with g."""
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


def stem_wgrad(xf: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The stem's weight gradient (cout, cin, 5, 5, 5), f32 (float64 for
    float64 inputs on the CPU), from the folded volume xf (1, D, H, W, 8
    cin) and the folded conv's output cotangent g (1, cout, D, H, W): the
    plain version for a CPU tensor, the CUDA kernel for a CUDA tensor (or
    it raises)."""
    if xf.device.type == "cpu":
        return stem_wgrad_unfold(stem_wgrad_folded_plain(xf, g))
    from neraf_tpu_torch.ops.cuda.stem_wgrad import stem_wgrad_cuda

    return stem_wgrad_cuda(xf, g)
