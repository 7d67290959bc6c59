"""Wrapper of the fused PE+MLP CUDA kernel (csrc/pe_mlp.cu).

Replaces neraf_tpu/ops/pallas/fused_pe_mlp.py::pe_mlp (forward). The bf16
kernel keeps every activation in registers (the mma accumulators of one
layer are the next layer's operands) and stages one layer's weights at a
time in shared memory; it is bound by the tensor cores fed by mma.sync and
by shared-memory reads of the weights (see the source's note). The f32
kernel runs the same function on the CUDA cores for checks in f32.

A CPU tensor takes the plain version (ops/pe_mlp.py::pe_mlp_plain); a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from neraf_tpu_torch.ops.encodings import nerf_frequencies
from neraf_tpu_torch.ops.pe_mlp import pack_layers, pe_mlp_plain

LAUNCHES = 0  # kernel launches since the last reset; chip_smoke.py reads it
MAX_FREQUENCIES = 10  # 6F + 3 <= 64
MAX_OUT = 32


def pe_mlp_cuda(x: torch.Tensor, layers, num_frequencies: int = 6,
                min_exp: float = 0.0, max_exp: float = 8.0,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x (N, 3) f32 -> (N, O) f32 through the kernel (bf16 tensor-core or
    f32 CUDA-core instantiation, by `dtype`)."""
    global LAUNCHES
    if x.device.type == "cpu":
        return pe_mlp_plain(x, layers, num_frequencies, min_exp, max_exp, dtype)
    if x.device.type != "cuda":
        raise ValueError(f"pe_mlp_cuda: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3:
        raise TypeError(f"pe_mlp_cuda: needs (N, 3) float32 x, got "
                        f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("pe_mlp_cuda: x must be contiguous")
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"pe_mlp_cuda: compute dtype {dtype} (bfloat16 or "
                        "float32)")
    if not 1 <= num_frequencies <= MAX_FREQUENCIES:
        raise ValueError(f"pe_mlp_cuda: {num_frequencies} frequencies "
                         f"(1..{MAX_FREQUENCIES})")
    for w, b in layers:
        if w.device != x.device or b.device != x.device:
            raise ValueError("pe_mlp_cuda: weights and x on different devices")
    w, b, dims = pack_layers(layers, num_frequencies, dtype)
    if dims["op"] > MAX_OUT:
        raise ValueError(f"pe_mlp_cuda: {dims['out_dim']} outputs > {MAX_OUT}")

    from neraf_tpu_torch.ops.cuda import build

    lib = build.load()
    n = x.shape[0]
    out = torch.empty((n, dims["out_dim"]), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    freqs = nerf_frequencies(num_frequencies, min_exp, max_exp, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.neraf_pe_mlp_launch(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), freqs.data_ptr(),
            out.data_ptr(), n, num_frequencies, dims["k0p"], dims["hp"],
            dims["n_hidden"], dims["out_dim"], dims["op"],
            int(dtype == torch.bfloat16), stream)
    build.check(lib, err, "pe_mlp kernel launch")
    LAUNCHES += 1
    return out
