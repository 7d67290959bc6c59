"""3D ResNet scene-grid encoder (counterpart of neraf_tpu/models/resnet3d.py).

conv5^3/s2 -> BN/ReLU -> maxpool3/s2 -> residual stages [layer1..3(,4)] ->
average pool over the remaining volume -> one (feature_dim,) descriptor.
The input is an NDHWC volume, as in the JAX package; it is permuted to NCDHW
inside. The stem is the direct k5/s2 convolution and the max pool the joint
3^3 window (the JAX package's s2d stem and separable pool are TPU layout
devices with the same forward values; the separable pool routes a gradient
on an exact tie to another element).

With `stem_wgrad_kernel` set (the joint step sets it from
NERAF_STEM_WGRAD_PALLAS=1), the stem runs in train mode with gradients
enabled through ops/stem_conv.py::StemConvFunction, on the NDHWC volume
itself: the same forward, the input gradient from cuDNN's, and the weight
gradient from ops/stem_wgrad.py, the CUDA kernel on a card (the counterpart
of the JAX package's Pallas stem weight gradient). Eval mode, and the
render path, keep the plain nn.Conv3d.

BatchNorm (eps 1e-5) follows flax: in eval mode it uses the running
statistics; in train mode (the joint step) it normalises with the batch-1
statistics over D, H and W and, while `update_stats` is set, moves the
running statistics by momentum 0.1 (flax's 0.9) towards the batch mean and
the BIASED batch variance, where nn.BatchNorm3d would take the unbiased one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from neraf_tpu_torch.ops.stem_conv import stem_conv


class BatchNorm3d(nn.BatchNorm3d):
    """nn.BatchNorm3d with flax's train-mode running-statistics update."""

    update_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        # native_batch_norm, not F.batch_norm: it returns the batch mean and
        # inverse std it normalised with (the biased variance, with no second
        # pass over x), and takes a 1^3 volume (layer3 of a 16^3 grid), one
        # value per channel, which flax normalises to 0
        out, mean, invstd = torch.ops.aten.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        if self.update_stats:
            with torch.no_grad():
                var = invstd.float().reciprocal().square() - self.eps
                self.running_mean.lerp_(mean.float(), self.momentum)
                self.running_var.lerp_(var, self.momentum)
        return out


def _bn(ch: int) -> BatchNorm3d:
    return BatchNorm3d(ch, eps=1e-5, momentum=0.1)


class Bottleneck3D(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = nn.Conv3d(in_ch, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv3d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = nn.Conv3d(planes, out_ch, 1, bias=False)
        self.bn3 = _bn(out_ch)
        if downsample:
            self.down_conv = nn.Conv3d(in_ch, out_ch, 1, stride, bias=False)
            self.down_bn = _bn(out_ch)
        self.downsample = downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = self.down_bn(self.down_conv(x)) if self.downsample else x
        return F.relu(out + residual)


class BasicBlock3D(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv3d(in_ch, planes, 3, stride, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv3d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = _bn(planes)
        if downsample:
            self.down_conv = nn.Conv3d(in_ch, planes, 1, stride, bias=False)
            self.down_bn = _bn(planes)
        self.downsample = downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = self.down_bn(self.down_conv(x)) if self.downsample else x
        return F.relu(out + residual)


_BACKBONES = {
    "resnet18": (BasicBlock3D, (2, 2, 2, 2)),
    "resnet34": (BasicBlock3D, (3, 4, 6, 3)),
    "resnet50": (Bottleneck3D, (3, 4, 6, 3)),
    "resnet101": (Bottleneck3D, (3, 4, 23, 3)),
    "resnet152": (Bottleneck3D, (3, 8, 36, 3)),
}


class ResNet3D(nn.Module):
    """(N, D, H, W, C_in) NDHWC -> (N, feature_dim) float32.

    layer4 runs only when n_features == 2048. Built in eval mode.
    stem_wgrad_kernel: the stem's weight gradient from the kernel (module
    docstring); batch 1 only.
    """

    stem_wgrad_kernel = False

    def __init__(self, backbone: str = "resnet50", n_features: int = 1024,
                 in_channels: int = 7):
        super().__init__()
        if n_features not in (1024, 2048):
            raise ValueError("n_features must be 1024 or 2048")
        self.backbone = backbone
        self.n_features = n_features
        block, layers = _BACKBONES[backbone]
        self.conv1 = nn.Conv3d(in_channels, 64, 5, 2, 2, bias=False)
        self.bn1 = _bn(64)
        stages = [(64, 1), (128, 2), (256, 2)]
        if n_features == 2048:
            stages.append((512, 2))
        in_ch = 64
        for i, ((planes, stride), blocks) in enumerate(zip(stages, layers)):
            seq = []
            for b in range(blocks):
                s = stride if b == 0 else 1
                down = b == 0 and (stride != 1 or in_ch != planes * block.expansion)
                seq.append(block(in_ch, planes, s, down))
                in_ch = planes * block.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*seq))
        self.n_stages = len(stages)
        self.eval()

    @property
    def feature_dim(self) -> int:
        block, _ = _BACKBONES[self.backbone]
        return (512 if self.n_features == 2048 else 256) * block.expansion

    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax defaults: Xavier-normal convs; BN scale 1, bias 0, stats 0/1."""
        for mod in self.modules():
            if isinstance(mod, nn.Conv3d):
                nn.init.xavier_normal_(mod.weight, generator=generator)
            elif isinstance(mod, nn.BatchNorm3d):
                mod.reset_parameters()

    def set_update_stats(self, on: bool) -> None:
        """Whether train-mode BatchNorm moves the running statistics (the
        joint step gates it on the audio branch being live)."""
        for mod in self.modules():
            if isinstance(mod, BatchNorm3d):
                mod.update_stats = on

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """The stem convolution of the NDHWC volume x, before bn1 -> (1, 64,
        Do, Ho, Wo). It stays on the 7 grid channels: padded to 8, cuDNN's
        forward took no tensor-core kernel and ran slower (PERF.md)."""
        dtype = self.conv1.weight.dtype
        if self.stem_wgrad_kernel and self.training and torch.is_grad_enabled():
            return stem_conv(x.to(dtype), self.conv1.weight)
        return self.conv1(x.permute(0, 4, 1, 2, 3).to(dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.stem(x)))
        x = F.max_pool3d(x, 3, 2, 1)
        for i in range(self.n_stages):
            x = getattr(self, f"layer{i + 1}")(x)
        # the grid is a cube, so the JAX pool's window is the whole volume
        return x.mean(dim=(2, 3, 4)).to(torch.float32)
