"""Wrapper of the shifted-slice concat CUDA kernel (csrc/shifted_concat.cu).

Replaces neraf_tpu/ops/pallas/gl_crash_repro.py::shifted_value_concat. A
copy bound by device memory: one thread per 16 bytes of the output when HOP
is a multiple of 4, else per float. Bitwise equal to the plain version.
"""

from __future__ import annotations

import torch

from neraf_tpu_torch.utils.profiling import count



def shifted_value_concat_cuda(x: torch.Tensor, t: int) -> torch.Tensor:
    """x (M, ROWS, HOP) f32 on the card, t <= ROWS - 1 -> (M, t, 2 HOP)."""
    from neraf_tpu_torch.ops.cuda import build

    if x.device.type != "cuda":
        raise ValueError(f"shifted_value_concat_cuda: unsupported device "
                         f"{x.device}")
    if x.dtype != torch.float32 or x.dim() != 3:
        raise TypeError(f"shifted_value_concat_cuda: needs (M, ROWS, HOP) "
                        f"float32, got {tuple(x.shape)} {x.dtype}")
    m, rows, hop = x.shape
    if not 0 <= t <= rows - 1 or x.numel() >= 2**31 or m * t * 2 * hop >= 2**31:
        raise ValueError(f"shifted_value_concat_cuda: t {t} for {rows} rows "
                         f"(0 <= t <= rows - 1, under 2^31 elements)")
    x = x.contiguous()
    out = torch.empty((m, t, 2 * hop), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    lib = build.load()
    with torch.cuda.device(x.device):
        err = lib.neraf_shifted_concat_launch(
            x.data_ptr(), out.data_ptr(), m, rows, t, hop,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "shifted concat kernel launch")
    count("kernel.shifted_concat")
    return out
