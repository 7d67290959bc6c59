"""Wrapper of the stem weight-gradient CUDA kernel (csrc/stem_wgrad.cu).

Replaces neraf_tpu/ops/pallas/stem_wgrad_kernel.py::stem_wgrad_pallas and
reads what it reads, the space-to-depth folded volume. A call is three
launches (see the source's note): a pass that unfolds the folded volume
into a scratch volume, each grid voxel a row with its channels padded to
8, the even and odd w positions of each line apart; the split-K product on
the tensor cores (bf16 wgmma m64n40k16, one (kd, kw) group of 5 taps x 8
channels a product, f32 accumulators, the bricks staged by TMA; an f32
CUDA-core instantiation for checks in f32), each block taking half of the
taps and a slice of the output bricks; and a reduction that sums the
slices in a fixed order.

Layouts: xf is the folded NDHWC volume (1, D, H, W, 8 cin), cin <= 8
(models/grid.py::fold_volume of the ResNet's 7 grid channels: 56), read as
it lies; dW comes back in the Conv3d layout of the direct stem weight,
(64, cin, 5, 5, 5), the function the TPU kernel's (3, 3, 3, 8 cin, 64)
output is up to the fold (ops/stem_wgrad.py::stem_wgrad_unfold). g is the
cotangent (1, 64, D, H, W) of the folded conv's output, which the kernel
reads channels innermost: ``g.permute(0, 2, 3, 4, 1).contiguous()`` is free
when g is in channels_last_3d, the memory format the conv of the permuted
NDHWC volume gives its output, and a copy otherwise.
"""

from __future__ import annotations

import torch

from neraf_tpu_torch.utils.profiling import count

CIN_PAD = 8  # the kernel's input channels
COUT = 64  # the stem's output channels


def launch_plan(out_shape, bf16: bool, sms: int) -> dict:
    """The kernel's split of the (Do, Ho, Wo) output voxels: bricks of 2 x
    4 x 16 output voxels in bf16 (8 k16 steps of the wgmma kernel), 1 x 4 x
    16 in f32, counted along (d, h, w) with w fastest, and `slices` =
    min(sms / 2, bricks) slices (blockIdx.x), slice c taking bricks
    [c n / slices, (c + 1) n / slices); each slice is two blocks
    (blockIdx.y), one an SM."""
    bd, bh, bw = (2 if bf16 else 1), 4, 16
    nb = tuple(-(-n // k) for n, k in zip(out_shape, (bd, bh, bw)))
    nbricks = nb[0] * nb[1] * nb[2]
    slices = max(1, min(sms // 2, nbricks))
    return {"brick": (bd, bh, bw), "grid": nb, "nbricks": nbricks,
            "slices": slices,
            "ranges": [(c * nbricks // slices, (c + 1) * nbricks // slices)
                       for c in range(slices)]}


def _check(xf: torch.Tensor, g: torch.Tensor) -> None:
    if xf.dtype not in (torch.bfloat16, torch.float32) or g.dtype != xf.dtype:
        raise TypeError(f"stem_wgrad_cuda: needs bfloat16 or float32 xf and g "
                        f"of one type, got {xf.dtype} and {g.dtype}")
    if xf.dim() != 5 or g.dim() != 5 or xf.shape[0] != 1 or g.shape[0] != 1:
        raise ValueError(f"stem_wgrad_cuda: xf {tuple(xf.shape)} and g "
                         f"{tuple(g.shape)} are not batch-1 5-d volumes")
    c8 = xf.shape[-1]
    if not (8 <= c8 <= 8 * CIN_PAD and c8 % 8 == 0) or g.shape[1] != COUT or (
            g.shape[2:] != xf.shape[1:4]):
        raise ValueError(f"stem_wgrad_cuda: xf {tuple(xf.shape)}, g "
                         f"{tuple(g.shape)}: needs 8 x 1..{CIN_PAD} folded "
                         f"input channels, {COUT} output channels and g over "
                         f"the folded conv's output voxels, xf's "
                         f"{tuple(xf.shape[1:4])}")
    if xf.device.type != "cuda":
        raise ValueError(f"stem_wgrad_cuda: unsupported device {xf.device}")
    if g.device != xf.device:
        raise ValueError("stem_wgrad_cuda: xf and g on different devices")


def stem_wgrad_cuda(xf: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """xf (1, D, H, W, 8 cin) folded, cin <= 8, g (1, 64, D, H, W), bf16 or
    f32 -> dW (64, cin, 5, 5, 5) f32: one call of the kernel's three
    launches (the split copy unfolding xf, the split-K product over
    launch_plan's slices of the output bricks, and the reduction)."""
    from neraf_tpu_torch.ops.cuda import build

    _check(xf, g)
    _, D, H, W, c8 = xf.shape
    cin = c8 // 8
    xf = xf.contiguous()
    g = g.permute(0, 2, 3, 4, 1).contiguous()
    dev = xf.device
    bf16 = xf.dtype == torch.bfloat16
    slices = launch_plan((D, H, W), bf16, torch.cuda.get_device_properties(
        dev).multi_processor_count)["slices"]
    total = COUT * CIN_PAD * 125
    lib = build.load()
    xs = torch.empty((8 * D * H * W * CIN_PAD,), dtype=xf.dtype, device=dev)
    part = torch.empty(((slices + 1) * total,), dtype=torch.float32, device=dev)
    out = part[slices * total:]
    with torch.cuda.device(dev):
        err = lib.neraf_stem_wgrad_launch(
            xf.data_ptr(), g.data_ptr(), xs.data_ptr(), part.data_ptr(),
            out.data_ptr(), D, H, W, cin, D, H, W, slices, int(bf16),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "stem weight-gradient kernel launch")
    count("kernel.stem_wgrad")
    return out.view(COUT, CIN_PAD, 5, 5, 5)[:, :cin]
