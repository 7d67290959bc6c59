"""3D ResNet scene-grid encoder (counterpart of neraf_tpu/models/resnet3d.py).

conv5^3/s2 -> BN/ReLU -> maxpool3/s2 -> residual stages [layer1..3(,4)] ->
average pool over the remaining volume -> one (feature_dim,) descriptor.
The input is an NDHWC volume, as in the JAX package; it is permuted to NCDHW
inside.

The ResNet has one layout, where the JAX ResNet3D has two fields. Its max
pool is the joint 3^3 window, where the JAX default (pool_impl="separable")
is three 1-D pools: the values are the same (a max over a box factorises,
-inf padding included), and on an exact tie inside a window the separable
pool routes the gradient to another, equal-valued element. On an H100
(80GB HBM3, 700 W; chip_smoke.py phase 25) the joint pool at the stem's
output (1, 64, 64^3, bf16), fwd + bwd, takes 0.382-0.474 ms against the
separable's 0.607-0.632 (medians in turns, two runs): the separable pool's
three passes write three outputs and three index tensors, and the cheaper
1-D backwards they bought on the TPU are not cheaper here. Its convolutions are cuDNN's;
the JAX conv_impl="mm_wgrad" (a weight gradient of one product per kernel
tap) is not ported, as no configuration sets it. The port's ResNet matches
each JAX setting (tests/test_torch_conv3d.py).

The stem (ResNet3D.stem, the JAX package's _StemConv) keeps its weight in
the direct layout, conv1.weight (64, 7, 5, 5, 5), and runs space-to-depth
folded, the reference's default: the volume cast to the compute dtype,
each 2^3 block folded into 56 channels (models/grid.py::fold_volume) and
one conv, kernel 3, stride 1, with the folded weight
(ops/stem_wgrad.py::fold_weight); the same function as the direct conv up
to the order of its sums. A volume with an odd side takes the direct conv.
The joint step hands the stem the pre-folded grid with the live slab of
its fresh cells (bake_slab), which goes through
ops/baked_stem.py::StemConvBaked: the input gradient of the slab alone
and, with the slab's use_kernel flag (NERAF_STEM_WGRAD_PALLAS=1), the
weight gradient from the CUDA kernel csrc/stem_wgrad.cu on a card (the
plain version on the CPU).

Under a data mesh (forward's `mesh`) the ResNet runs split by depth over
the ranks where the JAX package's reshard hook splits it: each rank's
block of planes, with halo exchanges for the windowed ops, BatchNorm
statistics and the final pool over the global volume, the stages below
the rule's 2 planes a shard whole on every rank (parallel/depth_split.py;
the stem reads its window of the volume every rank holds whole). One
forward serves both: without a mesh the rule splits nothing and each op
of DepthSplit is the plain one.

BatchNorm (eps 1e-5) follows flax: in eval mode it uses the running
statistics in flax's own arithmetic; in train mode (the joint step) it
normalises with the batch-1 statistics over D, H and W and, while
`update_stats` is set, moves the running statistics by momentum 0.1
(flax's 0.9) towards the batch mean and the BIASED batch variance, where
nn.BatchNorm3d would take the unbiased one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from neraf_tpu_torch.models.grid import fold_volume
from neraf_tpu_torch.ops.baked_stem import stem_conv_baked
from neraf_tpu_torch.ops.stem_wgrad import fold_weight
from neraf_tpu_torch.parallel.depth_split import DepthSplit, local_window, splits


class BatchNorm3d(nn.BatchNorm3d):
    """nn.BatchNorm3d with flax's eval arithmetic and train-mode
    running-statistics update.

    Eval mode computes (x - mean) * (rsqrt(var + eps) * scale) + bias, as
    flax's BatchNorm does, in x's type promoted with the statistics'
    (float32 for a bf16 x) and returned in x's type, as flax returns its
    compute dtype."""

    update_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            shape = (1, -1) + (1,) * (x.dim() - 2)
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            return ((x - self.running_mean.view(shape)) * mul.view(shape)
                    + self.bias.view(shape)).to(x.dtype)
        # native_batch_norm, not F.batch_norm: it returns the batch mean and
        # inverse std it normalised with (the biased variance, with no second
        # pass over x), and takes a 1^3 volume (layer3 of a 16^3 grid), one
        # value per channel, which flax normalises to 0
        out, mean, invstd = torch.ops.aten.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        if self.update_stats:
            with torch.no_grad():
                dt = self.running_mean.dtype  # float32, float64 for a .double()
                var = invstd.to(dt).reciprocal().square() - self.eps
                self.running_mean.lerp_(mean.to(dt), self.momentum)
                self.running_var.lerp_(var, self.momentum)
        return out

    def forward_split(self, x: torch.Tensor, mean: torch.Tensor,
                      var: torch.Tensor) -> torch.Tensor:
        """Train mode on a rank's slab of a depth-split volume, normalised
        with the global batch mean and biased variance in float32
        (parallel/depth_split.py::batch_norm_stats, differentiable),
        which move the running statistics as forward does; computed in
        the statistics' type and returned in x's type."""
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        out = ((x.to(mean.dtype) - mean.view(shape)) * mul.view(shape)
               + self.bias.view(shape)).to(x.dtype)
        if self.update_stats:
            with torch.no_grad():
                self.running_mean.lerp_(mean.detach(), self.momentum)
                self.running_var.lerp_(var.detach(), self.momentum)
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
        self.stride = stride

    def forward(self, x, depth=None, sp: DepthSplit | None = None):
        """x, or a rank's slab of `depth` planes of it (None: whole), under
        sp (default one rank) -> (out, its depth)."""
        sp = sp or DepthSplit()
        out, d = sp.conv(self.conv1, x, depth)
        out = F.relu(sp.batch_norm(self.bn1, out, d))
        out, d = sp.conv(self.conv2, out, d)
        out = F.relu(sp.batch_norm(self.bn2, out, d))
        out, d = sp.conv(self.conv3, out, d)
        out = sp.batch_norm(self.bn3, out, d)
        residual = x
        if self.downsample:
            residual, _ = sp.conv(self.down_conv, x, depth)
            residual = sp.batch_norm(self.down_bn, residual, d)
        return F.relu(out + residual), d


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
        self.stride = stride

    def forward(self, x, depth=None, sp: DepthSplit | None = None):
        """x, or a rank's slab of `depth` planes of it (None: whole), under
        sp (default one rank) -> (out, its depth)."""
        sp = sp or DepthSplit()
        out, d = sp.conv(self.conv1, x, depth)
        out = F.relu(sp.batch_norm(self.bn1, out, d))
        out, d = sp.conv(self.conv2, out, d)
        out = sp.batch_norm(self.bn2, out, d)
        residual = x
        if self.downsample:
            residual, _ = sp.conv(self.down_conv, x, depth)
            residual = sp.batch_norm(self.down_bn, residual, d)
        return F.relu(out + residual), d


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

    def set_update_stats(self, on: bool) -> None:
        """Whether train-mode BatchNorm moves the running statistics (the
        joint step gates it on the audio branch being live)."""
        for mod in self.modules():
            if isinstance(mod, BatchNorm3d):
                mod.update_stats = on

    def stem(self, x: torch.Tensor, bake_slab=None) -> torch.Tensor:
        """The stem convolution, before bn1 -> (1, 64, Do, Ho, Wo).

        x: the NDHWC volume (1, D, H, W, 7); with bake_slab, the folded
        state (1, D/2, H/2, W/2, 56) in the compute dtype and (slab, d0,
        h0, ch_off, use_kernel) of the live slab spliced into it
        (models/grid.py::bake_cells_folded), for StemConvBaked."""
        w = self.conv1.weight
        if bake_slab is not None:
            slab, d0, h0, ch_off, use_kernel = bake_slab
            return stem_conv_baked(x, slab, d0, h0, ch_off, w, use_kernel)
        dev = x.device.type
        dtype = (torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev)
                 else w.dtype)
        if any(n % 2 for n in x.shape[1:4]):
            return self.conv1(x.permute(0, 4, 1, 2, 3).to(dtype))
        return F.conv3d(fold_volume(x, dtype).permute(0, 4, 1, 2, 3),
                        fold_weight(w.to(dtype)), None, 1, 1)

    def _stem_split(self, x, bake_slab, sp: DepthSplit):
        """The stem under sp -> (out, its depth): where the JAX
        rule splits the stem's input (depth >= 4 N before the fold, 2 N
        after it), this rank's block of the output planes, from a window of
        the volume (every rank holds it whole) with one output plane's
        halo on each side, zeros beyond the edge; else the whole stem."""
        w = self.conv1.weight
        world = sp.world
        if bake_slab is not None:
            depth = x.shape[1]
            if not splits(depth, 1, world):
                sp.trace.append(("conv", depth, depth, False))
                return self.stem(x, bake_slab), None
            lo, hi = sp.block(depth)
            slab, d0, h0, ch_off, use_kernel = bake_slab
            out = stem_conv_baked(x, slab, d0, h0, ch_off, w, use_kernel,
                                  planes=(lo, max(hi, lo + 1)))
            sp.trace.append(("conv", out.shape[2] + 2, depth, True))
            return out[:, :, :hi - lo], depth
        depth = x.shape[1]
        if not splits(depth, 2, world):
            # the conv's input: the folded volume, or the volume (odd sides)
            d_in = depth if any(n % 2 for n in x.shape[1:4]) else depth // 2
            sp.trace.append(("conv", d_in, d_in, False))
            return self.stem(x), None
        dev = x.device.type
        dtype = (torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev)
                 else w.dtype)
        if any(n % 2 for n in x.shape[1:4]):
            d_out = (depth - 1) // 2 + 1
            lo, hi = sp.block(d_out)
            win = local_window(x, 1, 2 * lo - 2, 2 * max(hi, lo + 1) + 1)
            out = F.conv3d(win.permute(0, 4, 1, 2, 3).to(dtype), w.to(dtype),
                           None, 2, (0, 2, 2))
            sp.trace.append(("conv", win.shape[1], depth, True))
        else:
            d_out = depth // 2
            lo, hi = sp.block(d_out)
            win = local_window(x, 1, 2 * lo - 2, 2 * max(hi, lo + 1) + 2)
            out = F.conv3d(fold_volume(win, dtype).permute(0, 4, 1, 2, 3),
                           fold_weight(w.to(dtype)), None, 1, (0, 1, 1))
            # the conv's input: the folded window of the folded volume
            sp.trace.append(("conv", win.shape[1] // 2, d_out, True))
        return out[:, :, :hi - lo], d_out

    def forward(self, x: torch.Tensor, bake_slab=None,
                mesh=None) -> torch.Tensor:
        """x as ResNet3D.stem takes it -> (1, feature_dim) float32. Under a
        data mesh of more than one rank (parallel/sharding.py, every rank
        calling it on the same x) the volume is split by depth over the
        ranks where the JAX package's reshard hook splits it
        (parallel/depth_split.py: the stem's input, before the max pool
        and at each stage's entry), and every rank returns the feature;
        without one (or at one rank) the rule splits nothing and every op
        runs whole. `split_trace` lists the planes each conv and the pool
        read on this rank (DepthSplit.trace)."""
        sp = DepthSplit(mesh)
        x, d = self._stem_split(x, bake_slab, sp)
        x = F.relu(sp.batch_norm(self.bn1, x, d))
        x, d = sp.reshard(x, d, 2)
        x, d = sp.max_pool(x, d)
        for i in range(self.n_stages):
            layer = getattr(self, f"layer{i + 1}")
            x, d = sp.reshard(x, d, layer[0].stride)
            for block in layer:
                x, d = block(x, d, sp)
        self.split_trace = sp.trace
        # the grid is a cube, so the JAX pool's window is the whole volume
        return sp.mean(x, d).to(torch.float32)
