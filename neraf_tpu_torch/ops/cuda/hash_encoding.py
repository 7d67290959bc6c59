"""Wrapper of the hash-grid encoding CUDA kernels (csrc/hash_encoding.cu,
forward and backward).

Replaces neraf_tpu/ops/pallas/hash_gather_attempt.py::pallas_vector_gather,
the table gather the TPU could not compile, and the XLA encoding around it
(neraf_tpu/ops/hashgrid.py::hash_encoding with gather_rows' scatter VJP).
Both kernels run one thread a point, a warp on 32 consecutive points, over
the levels: the forward is bound by the L2 sectors of its 8 table rows a
point and level, the backward by its atomic adds into the table's gradient,
which a warp's points in one cell make once a corner with one vector atomic
(see the source's note).

With gradients enabled and the table or x requiring one,
``hash_encoding_cuda`` runs through HashEncodingFunction: the forward kernel,
then the backward kernel, which fills a zeroed dense (L*T, F) table gradient
and dx (skipped when x needs none). Otherwise (no_grad, inference_mode) it is
one forward launch. A CPU tensor takes the plain version
(ops/hashgrid.py::hash_encoding_plain); a CUDA tensor launches the kernels
or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from neraf_tpu_torch.ops.hashgrid import HashGridSpec, hash_encoding_plain
from neraf_tpu_torch.utils.profiling import count

MAX_LEVELS = 32
FEATURES = (2, 4)


@functools.lru_cache(maxsize=None)
def _levels(spec: HashGridSpec):
    """The per-level resolutions and dense flags as ctypes int arrays."""
    ints = ctypes.c_int * spec.num_levels
    return (ints(*(int(r) for r in spec.resolutions())),
            ints(*(int(d) for d in spec.dense_levels())))


def _check(table: torch.Tensor, x: torch.Tensor, spec: HashGridSpec) -> None:
    L, T, F = spec.num_levels, spec.table_size, spec.features_per_level
    if F not in FEATURES or not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"hash_encoding_cuda: {L} levels of {F} features "
                         f"(1..{MAX_LEVELS} levels of {FEATURES} features)")
    if x.device.type != "cuda":
        raise ValueError(f"hash_encoding_cuda: unsupported device {x.device}")
    if table.device != x.device:
        raise ValueError("hash_encoding_cuda: table and x on different devices")
    if x.dtype != torch.float32 or table.dtype != torch.float32:
        raise TypeError(f"hash_encoding_cuda: needs float32 table and x, got "
                        f"{table.dtype} and {x.dtype}")
    if tuple(table.shape) != (L, T, F) or not table.is_contiguous():
        raise ValueError(f"hash_encoding_cuda: table {tuple(table.shape)} is "
                         f"not a contiguous {(L, T, F)}")
    if x.dim() != 2 or x.shape[1] != 3 or not x.is_contiguous() or (
            x.shape[0] >= 2**31):
        raise ValueError(f"hash_encoding_cuda: x {tuple(x.shape)} is not a "
                         "contiguous (N, 3) with N < 2^31")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _forward(table: torch.Tensor, x: torch.Tensor, spec: HashGridSpec):
    """One forward launch: x (N, 3) f32 contiguous -> (N, L*F) f32."""
    from neraf_tpu_torch.ops.cuda import build

    lib = build.load()
    n = x.shape[0]
    out = torch.empty((n, spec.out_dim), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    res, dense = _levels(spec)
    with torch.cuda.device(x.device):
        err = lib.neraf_hash_encoding_launch(
            x.data_ptr(), table.data_ptr(), out.data_ptr(), n, spec.num_levels,
            spec.features_per_level, spec.log2_hashmap_size, res, dense,
            _stream(x.device))
    build.check(lib, err, "hash encoding kernel launch")
    count("kernel.hash_fwd")
    return out


def hash_encoding_bwd_cuda(table: torch.Tensor, x: torch.Tensor,
                           g: torch.Tensor, spec: HashGridSpec,
                           need_table: bool = True, need_dx: bool = True):
    """The backward for the output cotangent g (N, L*F) f32 -> the dense
    table gradient (L, T, F) f32 (atomic order) or None, and dx (N, 3) f32
    or None."""
    from neraf_tpu_torch.ops.cuda import build

    _check(table, x, spec)
    if tuple(g.shape) != (x.shape[0], spec.out_dim) or (
            g.dtype != torch.float32 or g.device != x.device):
        raise ValueError(f"hash_encoding_bwd_cuda: cotangent {tuple(g.shape)} "
                         f"{g.dtype} on {g.device}, not ({x.shape[0]}, "
                         f"{spec.out_dim}) f32 on {x.device}")
    if not g.is_contiguous() or g.data_ptr() % 16:  # rows read as vectors
        g = g.clone(memory_format=torch.contiguous_format)
    lib = build.load()
    n, dev = x.shape[0], x.device
    d_table = torch.zeros_like(table) if need_table else None
    dx = torch.empty((n, 3), dtype=torch.float32, device=dev) if need_dx else None
    if n == 0:
        return d_table, dx
    res, dense = _levels(spec)
    with torch.cuda.device(dev):
        err = lib.neraf_hash_encoding_bwd_launch(
            x.data_ptr(), table.data_ptr(), g.data_ptr(),
            0 if d_table is None else d_table.data_ptr(),
            0 if dx is None else dx.data_ptr(), n, spec.num_levels,
            spec.features_per_level, spec.log2_hashmap_size, res, dense,
            _stream(dev))
    build.check(lib, err, "hash encoding backward launch")
    count("kernel.hash_bwd")
    return d_table, dx


class HashEncodingFunction(torch.autograd.Function):
    """The hash encoding on the card with the backward kernel as its
    gradient. Saves the table and x, no intermediate."""

    @staticmethod
    def forward(ctx, table, x, spec):
        ctx.save_for_backward(table, x)
        ctx.spec = spec
        return _forward(table, x, spec)

    @staticmethod
    def backward(ctx, g):
        table, x = ctx.saved_tensors
        need_table, need_dx = ctx.needs_input_grad[:2]
        d_table, dx = hash_encoding_bwd_cuda(
            table, x, g.to(torch.float32), ctx.spec, need_table=need_table,
            need_dx=need_dx)
        return d_table, dx, None


def hash_encoding_cuda(table: torch.Tensor, x: torch.Tensor,
                       spec: HashGridSpec) -> torch.Tensor:
    """x (..., 3) f32 -> (..., L*F) f32 through the kernels, differentiable
    in the table and x."""
    if x.device.type == "cpu":
        return hash_encoding_plain(table, x, spec)
    lead = x.shape[:-1]
    flat = x.reshape(-1, 3).contiguous()
    _check(table, flat, spec)
    if torch.is_grad_enabled() and (x.requires_grad or table.requires_grad):
        out = HashEncodingFunction.apply(table, flat, spec)
    else:
        out = _forward(table, flat, spec)
    return out.reshape(*lead, spec.out_dim)
