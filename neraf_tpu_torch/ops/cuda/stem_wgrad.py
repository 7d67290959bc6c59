"""Wrapper of the stem weight-gradient CUDA kernel (csrc/stem_wgrad.cu).

Replaces neraf_tpu/ops/pallas/stem_wgrad_kernel.py::stem_wgrad_pallas. A
call is three launches (see the source's note): a pass that copies x into
a scratch volume with its channels padded to 8 and the even and odd w
positions of each line apart; the split-K product on the tensor cores
(bf16 wgmma m64n40k16, one (kd, kw) group of 5 taps x 8 channels a
product, f32 accumulators, the bricks staged by TMA; an f32 CUDA-core
instantiation for checks in f32), each block taking half of the taps and a
slice of the output bricks; and a reduction that sums the slices in a
fixed order.

Layouts: x is the NDHWC volume (1, D, H, W, cin <= 8), read as it lies
(the ResNet's 7 grid channels); dW comes back over its cin channels. g is
the cotangent (1, cout, Do, Ho, Wo) of the conv output, which the kernel
reads channels innermost: ``g.permute(0, 2, 3, 4, 1).contiguous()`` is free
when g is in channels_last_3d, the memory format the conv of the permuted
NDHWC volume gives its output, and a copy otherwise.
"""

from __future__ import annotations

import torch

LAUNCHES = 0  # kernel launches since the last reset (chip_smoke.py)
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


def _check(x: torch.Tensor, g: torch.Tensor) -> None:
    if x.dtype not in (torch.bfloat16, torch.float32) or g.dtype != x.dtype:
        raise TypeError(f"stem_wgrad_cuda: needs bfloat16 or float32 x and g "
                        f"of one type, got {x.dtype} and {g.dtype}")
    if x.dim() != 5 or g.dim() != 5 or x.shape[0] != 1 or g.shape[0] != 1:
        raise ValueError(f"stem_wgrad_cuda: x {tuple(x.shape)} and g "
                         f"{tuple(g.shape)} are not batch-1 5-d volumes")
    out = tuple((n - 1) // 2 + 1 for n in x.shape[1:4])
    if not 1 <= x.shape[-1] <= CIN_PAD or g.shape[1] != COUT or (
            tuple(g.shape[2:]) != out):
        raise ValueError(f"stem_wgrad_cuda: x {tuple(x.shape)}, g "
                         f"{tuple(g.shape)}: needs 1..{CIN_PAD} input "
                         f"channels, {COUT} output channels and g over the "
                         f"conv's {out} output voxels")
    if x.device.type != "cuda":
        raise ValueError(f"stem_wgrad_cuda: unsupported device {x.device}")
    if g.device != x.device:
        raise ValueError("stem_wgrad_cuda: x and g on different devices")


def stem_wgrad_cuda(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x (1, D, H, W, cin <= 8), g (1, 64, Do, Ho, Wo), bf16 or f32 -> dW
    (64, cin, 5, 5, 5) f32: one call of the kernel's three launches (the
    split copy of x, the split-K product over launch_plan's slices of the
    output bricks, and the reduction)."""
    global LAUNCHES
    from neraf_tpu_torch.ops.cuda import build

    _check(x, g)
    _, D, H, W, cin = x.shape
    Do, Ho, Wo = g.shape[2:]
    x = x.contiguous()
    g = g.permute(0, 2, 3, 4, 1).contiguous()
    dev = x.device
    bf16 = x.dtype == torch.bfloat16
    slices = launch_plan((Do, Ho, Wo), bf16, torch.cuda.get_device_properties(
        dev).multi_processor_count)["slices"]
    total = COUT * CIN_PAD * 125
    lib = build.load()
    xs = torch.empty((D * H * 2 * ((W + 1) // 2) * CIN_PAD,), dtype=x.dtype,
                     device=dev)
    part = torch.empty(((slices + 1) * total,), dtype=torch.float32, device=dev)
    out = part[slices * total:]
    with torch.cuda.device(dev):
        err = lib.neraf_stem_wgrad_launch(
            x.data_ptr(), g.data_ptr(), xs.data_ptr(), part.data_ptr(),
            out.data_ptr(), D, H, W, cin, Do, Ho, Wo, slices, int(bf16),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "stem weight-gradient kernel launch")
    LAUNCHES += 1
    return out.view(COUT, CIN_PAD, 5, 5, 5)[:, :cin]
