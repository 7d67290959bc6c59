"""3D ResNet scene-grid encoder, eval mode (counterpart of
neraf_tpu/models/resnet3d.py).

conv5^3/s2 -> BN/ReLU -> maxpool3/s2 -> residual stages [layer1..3(,4)] ->
average pool over the remaining volume -> one (feature_dim,) descriptor.
The input is an NDHWC volume, as in the JAX package; it is permuted to NCDHW
inside. BatchNorm uses eps 1e-5 and its running statistics. Training-mode
BatchNorm (batch-1 statistics) belongs to the joint train step, not here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _bn(ch: int) -> nn.BatchNorm3d:
    return nn.BatchNorm3d(ch, eps=1e-5, momentum=0.1)


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
    """(N, D, H, W, C_in) NDHWC -> (N, feature_dim) float32, eval mode.

    layer4 runs only when n_features == 2048.
    """

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise RuntimeError("ResNet3D is ported for eval mode only")
        x = x.permute(0, 4, 1, 2, 3).to(self.conv1.weight.dtype)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool3d(x, 3, 2, 1)
        for i in range(self.n_stages):
            x = getattr(self, f"layer{i + 1}")(x)
        # the grid is a cube, so the JAX pool's window is the whole volume
        return x.mean(dim=(2, 3, 4)).to(torch.float32)
