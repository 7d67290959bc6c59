"""Wrapper of the fused PE+MLP CUDA kernels (csrc/pe_mlp.cu forward,
csrc/pe_mlp_bwd.cu backward).

Replaces neraf_tpu/ops/pallas/fused_pe_mlp.py::pe_mlp and its custom VJP.
The bf16 kernels run on wgmma: persistent blocks of two warpgroups (64 rows
each) keep every activation in registers as the A operand (one layer's
accumulator is the next layer's operand) and read the weights, in
tile_layers' layout, from shared memory, where a producer thread's bulk
copies put them: once per block when they fit, else streamed through a
ring. The backward recomputes the forward per row tile, walks back through
the layers, writes h and dpre (bf16) to scratch and per-block db partials,
then forms dW on wgmma as a split-K product over the rows, one launch a
layer, and sums the slices and partials in a fixed order (see the
sources' notes). The f32 kernels run the same functions on the CUDA cores
for checks in f32.

With gradients enabled and anything requiring one, ``pe_mlp_cuda`` runs
through PeMlpFunction: the forward kernel, then the backward kernel on the
weights packed once in the forward; it keeps only x and the packed weights,
no activation. Otherwise (no_grad, inference_mode) it is one forward launch;
inside a `weights_fixed()` scope (utils/weight_cache.py) its weights are
packed once a scope (`cached`: packing takes ~25 launches, and an image's
chunks call each chain on the same weights). A CPU tensor takes the plain version
(ops/pe_mlp.py::pe_mlp_plain); a CUDA tensor launches the kernels or
raises.
"""

from __future__ import annotations

import functools

import torch

from neraf_tpu_torch.ops.encodings import nerf_frequencies
from neraf_tpu_torch.ops.pe_mlp import (
    pack_layers,
    pe_mlp_plain,
    tile_layers,
    unpack_layers,
)
from neraf_tpu_torch.utils.profiling import count
from neraf_tpu_torch.utils.weight_cache import cached

# counters (utils/profiling.py): kernel.pe_mlp_fwd, a forward launch;
# kernel.pe_mlp_bwd, a backward call, which launches n_hidden + 3 device
# kernels (the row-tile kernel, one dW kernel per layer, the reduction of
# the dW slices and db partials), counted one by one by chip_smoke.py's
# profiler pass
MAX_FREQUENCIES = 10  # 6F + 3 <= 64
MAX_OUT = 32
ROW_TILE = 128  # rows of a bf16 kernel block's tile (two warpgroups of 64)
DW_M_TILE = 128  # output units of a dW block


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
    """pack_layers, then for bf16 tile_layers: the weights as the kernels
    read them."""
    w, b, dims = pack_layers(layers, num_frequencies, dtype)
    if dims["op"] > MAX_OUT:
        raise ValueError(f"pe_mlp_cuda: {dims['out_dim']} outputs > {MAX_OUT}")
    if dtype == torch.bfloat16:
        w = tile_layers(w, dims)
    return w, b, dims


def packed_sizes(dims: dict) -> tuple:
    """(weights, biases) of pack_layers' layout: the gradient's sizes."""
    k0p, hp, op, L = dims["k0p"], dims["hp"], dims["op"], dims["n_hidden"]
    return hp * k0p + (L - 1) * hp * hp + op * hp, L * hp + op


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def row_tile_blocks(n: int, sms: int) -> int:
    """Persistent blocks of the bf16 row-tile kernels: one an SM, at most
    one a 128-row tile."""
    return max(1, min(-(-n // ROW_TILE), sms))


def dw_slices(n: int, hp: int, sms: int) -> int:
    """Split-K slices of the dW products: M tiles x slices fill one wave of
    the SMs, and no slice is emptier than one 64-row step."""
    m_tiles = -(-hp // DW_M_TILE)
    steps = -(-n // ROW_TILE) * ROW_TILE // 64
    return max(1, min(-(-sms // m_tiles), steps))


@functools.lru_cache(maxsize=None)
def _frequencies(num_frequencies: int, min_exp: float, max_exp: float,
                 device: torch.device) -> torch.Tensor:
    """nerf_frequencies, made once a device (a forward launch reads them by
    address)."""
    with torch.inference_mode(False):
        return nerf_frequencies(num_frequencies, min_exp, max_exp, device)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _forward(x, w, b, dims, num_frequencies, min_exp, max_exp, dtype):
    """One forward launch on packed weights -> (N, O) f32."""
    from neraf_tpu_torch.ops.cuda import build

    lib = build.load()
    n = x.shape[0]
    out = torch.empty((n, dims["out_dim"]), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    freqs = _frequencies(num_frequencies, min_exp, max_exp, x.device)
    with torch.cuda.device(x.device):
        err = lib.neraf_pe_mlp_launch(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), freqs.data_ptr(),
            out.data_ptr(), n, num_frequencies, dims["k0p"], dims["hp"],
            dims["n_hidden"], dims["out_dim"], dims["op"],
            row_tile_blocks(n, _sms(x.device.index or 0)),
            int(dtype == torch.bfloat16), _stream(x.device))
    build.check(lib, err, "pe_mlp kernel launch")
    count("kernel.pe_mlp_fwd")
    return out


def pe_mlp_bwd_cuda(x, g, w, b, dims, num_frequencies, min_exp, max_exp,
                    dtype, need_dx: bool = True, need_params: bool = True):
    """The backward on packed weights (_pack's): x (N, 3) f32, the output
    cotangent g (N, O) f32 -> dx (N, 3) f32 or None, and the packed dW and
    db (f32, the layout of pack_layers) or None."""
    from neraf_tpu_torch.ops.cuda import build

    lib = build.load()
    n, dev = x.shape[0], x.device
    hp, L, op = dims["hp"], dims["n_hidden"], dims["op"]
    dx = torch.empty((n, 3), dtype=torch.float32, device=dev) if need_dx else None
    n_w, n_b = packed_sizes(dims)
    if n == 0:
        zeros = torch.zeros(n_w + n_b, dtype=torch.float32, device=dev)
        return dx, (zeros[:n_w], zeros[n_w:]) if need_params else None
    sms = _sms(dev.index or 0)
    slices, blocks = dw_slices(n, hp, sms), row_tile_blocks(n, sms)
    if dtype == torch.bfloat16:
        # h planes, then the dpre planes and the g plane, rows padded to
        # the row tiles; db partials one a row-tile block
        rows = -(-n // ROW_TILE) * ROW_TILE
        hbuf = torch.empty(L * rows * hp, dtype=dtype, device=dev)
        dpbuf = torch.empty(L * rows * hp + rows * (-(-op // 16) * 16),
                            dtype=dtype, device=dev)
        n_part = slices * n_w + blocks * n_b
    else:
        hbuf = torch.empty((L, n, hp), dtype=dtype, device=dev)
        dpbuf = torch.empty((L, n, hp), dtype=dtype, device=dev)
        n_part = slices * (n_w + n_b)
    part = out = None
    if need_params:
        part = torch.empty(n_part, dtype=torch.float32, device=dev)
        out = torch.empty(n_w + n_b, dtype=torch.float32, device=dev)
    freqs = nerf_frequencies(num_frequencies, min_exp, max_exp, dev)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        err = lib.neraf_pe_mlp_bwd_launch(
            x.data_ptr(), g.data_ptr(), w.data_ptr(), b.data_ptr(),
            freqs.data_ptr(), ptr(dx), hbuf.data_ptr(), dpbuf.data_ptr(),
            ptr(part), ptr(out), n, num_frequencies, dims["k0p"], hp, L,
            dims["out_dim"], op, slices, blocks,
            int(dtype == torch.bfloat16), _stream(dev))
    build.check(lib, err, "pe_mlp backward launch")
    count("kernel.pe_mlp_bwd")
    if out is None:
        return dx, None
    return dx, (out[:n_w], out[n_w:])


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
    w, b, dims = cached(("pe_mlp", num_frequencies, dtype), params,
                        lambda: _pack(layers, num_frequencies, dtype))
    return _forward(x, w, b, dims, num_frequencies, min_exp, max_exp, dtype)
