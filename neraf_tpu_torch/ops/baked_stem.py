"""The stem conv over the baked, pre-folded grid with a slab-local input
gradient (counterpart of neraf_tpu/ops/baked_stem.py).

In the joint step the ResNet stem reads the pre-folded grid volume, whose
only live gradient path is the slab of this step's fresh cells (4096 of
2,097,152 cells at R 128: one (1, 1, B/2R, R/2, 28) block of the folded
volume, models/grid.py::folded_slab); the rest of the volume is a
constant. Autograd would compute the conv's input gradient over the whole
volume and keep the slab's part. StemConvBaked computes it for the slab
alone: a (3, NH + 2, W) window of the output cotangent around the slab,
clamped at the volume's edge and zero-padded there, against the slab's
channel block of the folded weight, flipped (a valid conv in depth and
height, padding 1 in width).

Forward: the stem weight (cout, 7, 5, 5, 5) folded (ops/stem_wgrad.py::
fold_weight) and one conv3d, kernel 3, stride 1, padding 1, of the folded
volume through F.conv3d (cuDNN on a card: the JAX package leaves this conv
to XLA), the volume passed as the channels_last_3d view of its NDHWC
tensor, so that cuDNN takes a bf16 tensor-core engine. Weight gradient:
with `use_kernel` (the reference's NERAF_STEM_WGRAD_PALLAS=1 gate) from
ops/stem_wgrad.py::stem_wgrad, the CUDA kernel on a card and the plain
version on the CPU, rounded to the weight's type as the reference rounds
(baked_stem.py:90); otherwise cuDNN's weight gradient of the folded conv,
unfolded, as the reference takes XLA's. The volume gets no gradient.

On a rank of a depth-split ResNet (parallel/depth_split.py; `planes`, the
rank's block [lo, hi) of the output planes) the conv reads the window
[lo - 1, hi + 1) of the folded volume, zeros beyond its edge, with no
depth padding. The slab's input gradient is then this rank's part, from
the cotangent planes it holds (the bake's all_gather sums the ranks'
parts), and the weight gradient its partial sum over its output planes:
cuDNN's on the window with depth padding 0, or the kernel on the window
with the cotangent padded by one zero plane on each side, which the kernel
takes as a volume of its own shape (x zero outside it) without a change
to its body, at two planes' more work.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from neraf_tpu_torch.ops.stem_wgrad import fold_weight, stem_wgrad, unfold_weight
from neraf_tpu_torch.parallel.depth_split import local_window

# torch.profiler ranges around the forward and the backward, which a trace
# of the joint step reads to name the stem's device kernels
PROFILE_FORWARD = "stem_conv_baked.forward"
PROFILE_BACKWARD = "stem_conv_baked.backward"


def slab_input_grad(g: torch.Tensor, wp: torch.Tensor, slab_shape, d0: int,
                    h0: int, ch_off: int, g0: int = 0) -> torch.Tensor:
    """The folded conv's input gradient on the slab alone: g (1, cout, n,
    H, W) the output cotangent of the planes [g0, g0 + n) (the whole
    volume's by default), wp (cout, C8, 3, 3, 3) the folded weight -> (1,
    1, NH, W, C4) in the slab's layout. d_in[t] = sum_k g[t + 1 - k] wp[k]
    over the slab's voxels t, as a valid conv of the haloed window; planes
    of g outside [g0, g0 + n) count as zeros."""
    _, _, nh, w_sp, c4 = slab_shape
    H = g.shape[3]
    lo_h, hi_h = h0 - 1, h0 + nh + 1
    win = local_window(g, 2, d0 - 1 - g0, d0 + 2 - g0)
    win = F.pad(win[:, :, :, max(lo_h, 0):min(hi_h, H)],
                (0, 0, max(-lo_h, 0), max(hi_h - H, 0)))
    w_t = wp[:, ch_off:ch_off + c4].flip(2, 3, 4).transpose(0, 1)  # (C4, cout, ...)
    d_slab = F.conv3d(win, w_t, None, 1, (0, 0, 1))  # (1, C4, 1, NH, W)
    return d_slab.permute(0, 2, 3, 4, 1).reshape(slab_shape)


def window_cotangent(g: torch.Tensor) -> torch.Tensor:
    """The cotangent (1, cout, n, H, W) of a rank's n output planes as the
    stem kernel takes it with the window of n + 2 input planes: one zero
    plane on each side, channels innermost (channels_last_3d)."""
    gp = g.new_zeros((1, g.shape[2] + 2, *g.shape[3:], g.shape[1]))
    gp[:, 1:-1] = g.permute(0, 2, 3, 4, 1)
    return gp.permute(0, 4, 1, 2, 3)


class StemConvBaked(torch.autograd.Function):
    """(nf (1, D, H, W, C8) folded volume with the slab's values spliced
    in, slab (1, 1, NH, W, C4) the live slab, d0, h0, ch_off its placement,
    weight (cout, C8/8, 5, 5, 5), use_kernel, planes) -> (1, cout, D, H,
    W), the conv of nf, or with planes (lo, hi) its output planes [lo,
    hi) alone; nf, slab and the weight share one dtype."""

    @staticmethod
    def forward(ctx, nf, slab, d0, h0, ch_off, weight, use_kernel, planes):
        with torch.profiler.record_function(PROFILE_FORWARD):
            wp = fold_weight(weight)
            pad, g0 = 1, 0
            if planes is not None:
                # the window of input planes [lo - 1, hi + 1), no depth padding
                g0 = planes[0]
                nf, pad = local_window(nf, 1, g0 - 1, planes[1] + 1), (0, 1, 1)
            ctx.save_for_backward(nf, wp)
            ctx.geo = (tuple(slab.shape), d0, h0, ch_off, use_kernel, g0,
                       planes is not None)
            return F.conv3d(nf.permute(0, 4, 1, 2, 3), wp, None, 1, pad)

    @staticmethod
    def backward(ctx, g):
        nf, wp = ctx.saved_tensors
        slab_shape, d0, h0, ch_off, use_kernel, g0, windowed = ctx.geo
        pad = (0, 1, 1) if windowed else (1,) * 3
        d_slab = dw = None
        with torch.profiler.record_function(PROFILE_BACKWARD):
            if ctx.needs_input_grad[1]:
                d_slab = slab_input_grad(g, wp, slab_shape, d0, h0, ch_off,
                                         g0)
            if ctx.needs_input_grad[5] and use_kernel:
                dw = stem_wgrad(nf, window_cotangent(g) if windowed
                                else g).to(wp.dtype)
            elif ctx.needs_input_grad[5]:
                dwp = torch.ops.aten.convolution_backward(
                    g, nf.permute(0, 4, 1, 2, 3), wp, None, (1,) * 3,
                    pad, (1,) * 3, False, (0,) * 3, 1,
                    (False, True, False))[1]
                dw = unfold_weight(dwp)
        return None, d_slab, None, None, None, dw, None, None


def stem_conv_baked(nf: torch.Tensor, slab: torch.Tensor, d0: int, h0: int,
                    ch_off: int, weight: torch.Tensor,
                    use_kernel: bool = False, planes=None) -> torch.Tensor:
    """StemConvBaked in nf's dtype: the slab and the weight cast to it
    first (the weight's cast carries its gradient to a float32 parameter),
    autocast kept from recasting. planes (lo, hi): the output planes [lo,
    hi) alone, a rank's block of a depth-split ResNet."""
    dev = nf.device.type
    with torch.autocast(dev, enabled=False):
        return StemConvBaked.apply(nf, slab.to(nf.dtype), d0, h0, ch_off,
                                   weight.to(nf.dtype), use_kernel, planes)
