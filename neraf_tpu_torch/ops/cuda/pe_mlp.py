"""Wrapper of the fused PE+MLP CUDA kernels (csrc/pe_mlp.cu forward,
csrc/pe_mlp_bwd.cu backward).

Replaces neraf_tpu/ops/pallas/fused_pe_mlp.py::pe_mlp and its custom VJP.
The bf16 forward kernel keeps every activation in registers (the mma
accumulators of one layer are the next layer's operands) and stages one
layer's weights at a time in shared memory; it is bound by the tensor cores
fed by mma.sync and by shared-memory reads of the weights. The backward
recomputes the forward per row tile, walks back through the layers, writes
h and dpre to scratch, and forms dW as a split-K product summed in a fixed
order (see the sources' notes). The f32 kernels run the same functions on
the CUDA cores for checks in f32.

With gradients enabled and anything requiring one, ``pe_mlp_cuda`` runs
through PeMlpFunction: the forward kernel, then the backward kernel on the
weights packed once in the forward; it keeps only x and the packed weights,
no activation. Otherwise (no_grad, inference_mode) it is one forward launch.
A CPU tensor takes the plain version (ops/pe_mlp.py::pe_mlp_plain); a CUDA
tensor launches the kernels or raises.
"""

from __future__ import annotations

import torch

from neraf_tpu_torch.ops.encodings import nerf_frequencies
from neraf_tpu_torch.ops.pe_mlp import pack_layers, pe_mlp_plain, unpack_layers

LAUNCHES = 0  # forward kernel launches since the last reset (chip_smoke.py)
# backward calls since the last reset: each call launches n_hidden + 3
# device kernels (the row-tile kernel, one dW kernel per layer, the
# reduction), counted one by one by chip_smoke.py's profiler pass
BWD_LAUNCHES = 0
MAX_FREQUENCIES = 10  # 6F + 3 <= 64
MAX_OUT = 32
DW_SLICES = 256  # the dW products split the rows into at most this many slices


def _check(x: torch.Tensor, layers, num_frequencies: int,
           dtype: torch.dtype) -> None:
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


def _pack(layers, num_frequencies: int, dtype: torch.dtype):
    w, b, dims = pack_layers(layers, num_frequencies, dtype)
    if dims["op"] > MAX_OUT:
        raise ValueError(f"pe_mlp_cuda: {dims['out_dim']} outputs > {MAX_OUT}")
    return w, b, dims


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _forward(x, w, b, dims, num_frequencies, min_exp, max_exp, dtype):
    """One forward launch on packed weights -> (N, O) f32."""
    global LAUNCHES
    from neraf_tpu_torch.ops.cuda import build

    lib = build.load()
    n = x.shape[0]
    out = torch.empty((n, dims["out_dim"]), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    freqs = nerf_frequencies(num_frequencies, min_exp, max_exp, x.device)
    with torch.cuda.device(x.device):
        err = lib.neraf_pe_mlp_launch(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), freqs.data_ptr(),
            out.data_ptr(), n, num_frequencies, dims["k0p"], dims["hp"],
            dims["n_hidden"], dims["out_dim"], dims["op"],
            int(dtype == torch.bfloat16), _stream(x.device))
    build.check(lib, err, "pe_mlp kernel launch")
    LAUNCHES += 1
    return out


def rows_per_slice(n: int) -> int:
    """Rows of one split-K slice of the dW products: a multiple of 32, at
    most DW_SLICES slices."""
    per = -(-n // DW_SLICES)
    return max(32, -(-per // 32) * 32)


def pe_mlp_bwd_cuda(x, g, w, b, dims, num_frequencies, min_exp, max_exp,
                    dtype, need_dx: bool = True, need_params: bool = True):
    """The backward on packed weights: x (N, 3) f32, the output cotangent g
    (N, O) f32 -> dx (N, 3) f32 or None, and the packed dW and db (f32, the
    layout of pack_layers) or None."""
    global BWD_LAUNCHES
    from neraf_tpu_torch.ops.cuda import build

    lib = build.load()
    n, dev = x.shape[0], x.device
    hp, L = dims["hp"], dims["n_hidden"]
    dx = torch.empty((n, 3), dtype=torch.float32, device=dev) if need_dx else None
    n_w, n_b = w.numel(), b.numel()
    if n == 0:
        zeros = torch.zeros(n_w + n_b, dtype=torch.float32, device=dev)
        return dx, (zeros[:n_w], zeros[n_w:]) if need_params else None
    slices = -(-n // rows_per_slice(n))
    hbuf = torch.empty((L, n, hp), dtype=dtype, device=dev)
    dpbuf = torch.empty((L, n, hp), dtype=torch.float32, device=dev)
    part = (torch.empty(((slices + 1) * (n_w + n_b),), dtype=torch.float32,
                        device=dev) if need_params else None)
    freqs = nerf_frequencies(num_frequencies, min_exp, max_exp, dev)
    with torch.cuda.device(dev):
        err = lib.neraf_pe_mlp_bwd_launch(
            x.data_ptr(), g.data_ptr(), w.data_ptr(), b.data_ptr(),
            freqs.data_ptr(), 0 if dx is None else dx.data_ptr(),
            hbuf.data_ptr(), dpbuf.data_ptr(),
            0 if part is None else part.data_ptr(), n, num_frequencies,
            dims["k0p"], hp, L, dims["out_dim"], dims["op"], rows_per_slice(n),
            int(dtype == torch.bfloat16), _stream(dev))
    build.check(lib, err, "pe_mlp backward launch")
    BWD_LAUNCHES += 1
    if part is None:
        return dx, None
    dwb = part[slices * (n_w + n_b):]
    return dx, (dwb[:n_w], dwb[n_w:])


class PeMlpFunction(torch.autograd.Function):
    """pe_mlp on the card with the backward kernel as its gradient. Saves x
    and the weights packed by the forward, no activation."""

    @staticmethod
    def forward(ctx, x, num_frequencies, min_exp, max_exp, dtype, *params):
        layers = list(zip(params[::2], params[1::2]))
        w, b, dims = _pack(layers, num_frequencies, dtype)
        ctx.save_for_backward(x, w, b)
        ctx.meta = (dims, num_frequencies, min_exp, max_exp, dtype,
                    layers[0][0].shape[0])
        return _forward(x, w, b, dims, num_frequencies, min_exp, max_exp, dtype)

    @staticmethod
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        dims, F, min_exp, max_exp, dtype, hidden = ctx.meta
        need = ctx.needs_input_grad
        dx, packed = pe_mlp_bwd_cuda(
            x, g.to(torch.float32).contiguous(), w, b, dims, F, min_exp,
            max_exp, dtype, need_dx=need[0], need_params=any(need[5:]))
        grads = [None] * (len(need) - 5)
        if packed is not None:
            flat = [t for wb in unpack_layers(*packed, dims, F, hidden)
                    for t in wb]
            grads = [t if want else None for t, want in zip(flat, need[5:])]
        return (dx, None, None, None, None, *grads)


def pe_mlp_cuda(x: torch.Tensor, layers, num_frequencies: int = 6,
                min_exp: float = 0.0, max_exp: float = 8.0,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x (N, 3) f32 -> (N, O) f32 through the kernels (bf16 tensor-core or
    f32 CUDA-core instantiation, by `dtype`), differentiable."""
    if x.device.type == "cpu":
        return pe_mlp_plain(x, layers, num_frequencies, min_exp, max_exp, dtype)
    _check(x, layers, num_frequencies, dtype)
    params = [t for wb in layers for t in wb]
    if torch.is_grad_enabled() and (x.requires_grad
                                    or any(p.requires_grad for p in params)):
        return PeMlpFunction.apply(x, num_frequencies, min_exp, max_exp,
                                   dtype, *params)
    w, b, dims = _pack(layers, num_frequencies, dtype)
    return _forward(x, w, b, dims, num_frequencies, min_exp, max_exp, dtype)
