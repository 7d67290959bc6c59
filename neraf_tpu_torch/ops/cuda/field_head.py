"""Wrapper of the colour-branch CUDA kernel (csrc/field_head.cu).

Replaces no TPU kernel: the JAX package leaves NerfactoField's colour
branch to XLA, which fuses it (ops/field_head.py). The kernel runs the
PE+MLP forward's row-tile engine (persistent blocks of two 64-row
warpgroups, the weights resident in shared memory, every activation in
registers) on layer-0 fragments it forms itself from the directions, the
geo features read in place from the base output and the appearance row.

``field_head_cuda`` is the inference-only half of ops/field_head.py's
dispatch: it takes no gradient, and is called only where none is recorded,
on a bf16 field. The directions and camera indices may be expands over the
samples of a ray (stride 0 along the last row dimension, as
VisionModel.forward passes them): the kernel then reads one direction and
camera for every S rows. Inside a weights_fixed() scope
(utils/weight_cache.py) the packed head and the averaged appearance row are
made once a scope: a render calls the kernel once a chunk on the same
weights.
"""

from __future__ import annotations

import torch

from neraf_tpu_torch.ops.cuda.pe_mlp import _sms, row_tile_blocks
from neraf_tpu_torch.ops.field_head import pack_head
from neraf_tpu_torch.ops.pe_mlp import tile_layers
from neraf_tpu_torch.utils.profiling import count
from neraf_tpu_torch.utils.weight_cache import cached

# counter (utils/profiling.py): kernel.field_head, a launch
MAX_OUT = 16


def pack(layers):
    """The head's weights as the kernel reads them (pack_head's bf16 in
    tile_layers' layout) and its f32 biases."""
    w, b, dims = pack_head(layers, torch.bfloat16)
    return tile_layers(w, dims), b, dims


def per_direction(t: torch.Tensor, lead: int):
    """t, whose first `lead` dimensions are the rows -> (one entry a
    direction, S): S the size of the last row dimension when t repeats
    along it (stride 0, an expand over a ray's samples), else 1."""
    if lead >= 2 and t.shape[lead - 1] > 1 and t.stride(lead - 1) == 0:
        return t.select(lead - 1, 0), t.shape[lead - 1]
    return t, 1


def _check(directions, geo, camera_indices, appearance, layers) -> None:
    dev = geo.device
    if dev.type != "cuda":
        raise ValueError(f"field_head_cuda: unsupported device {dev}")
    if any(t.device != dev for t in (directions, camera_indices, appearance,
                                     *(t for wb in layers for t in wb))):
        raise ValueError("field_head_cuda: tensors on different devices")
    if geo.dtype != torch.bfloat16 or directions.dtype != torch.float32:
        raise TypeError(f"field_head_cuda: needs bf16 geo and float32 "
                        f"directions, got {geo.dtype} and {directions.dtype}")
    if appearance.dtype != torch.float32 or appearance.dim() != 2:
        raise TypeError("field_head_cuda: needs a float32 (C, E) appearance "
                        f"table, got {tuple(appearance.shape)} {appearance.dtype}")
    lead = geo.shape[:-1]
    if directions.shape != (*lead, 3) or camera_indices.shape != lead:
        raise ValueError(f"field_head_cuda: directions {tuple(directions.shape)}"
                         f" and camera indices {tuple(camera_indices.shape)} "
                         f"for geo {tuple(geo.shape)}")
    if lead.numel() >= 2**31:
        raise ValueError(f"field_head_cuda: {lead.numel()} rows >= 2^31")
    k_in = 16 + geo.shape[-1] + appearance.shape[1]
    if layers[0][0].shape[1] != k_in:
        raise ValueError(f"field_head_cuda: the head takes "
                         f"{layers[0][0].shape[1]} inputs, x0 has {k_in}")
    if layers[-1][0].shape[0] > MAX_OUT:
        raise ValueError(f"field_head_cuda: {layers[-1][0].shape[0]} outputs "
                         f"> {MAX_OUT}")


def launch(dirs: torch.Tensor, S: int, rows: torch.Tensor, emb: torch.Tensor,
           cam: torch.Tensor | None, layers) -> torch.Tensor:
    """One launch on n = rows.shape[0] rows: row r reads direction r // S
    of dirs (ceil(n / S), 3) f32 and, with cam (ceil(n / S),) int64, that
    direction's camera row of emb (C, E) f32, else emb's row 0; rows (n, G)
    bf16 with unit column stride -> (n, out_dim) bf16."""
    from neraf_tpu_torch.ops.cuda import build

    n, G = rows.shape
    out = torch.empty((n, layers[-1][0].shape[0]), dtype=torch.bfloat16,
                      device=rows.device)
    if n == 0:
        return out
    w, b, dims = cached("field_head", [t for wb in layers for t in wb],
                        lambda: pack(layers))
    lib = build.load()
    with torch.cuda.device(rows.device):
        err = lib.neraf_field_head_launch(
            dirs.data_ptr(), rows.data_ptr(), emb.data_ptr(),
            0 if cam is None else cam.data_ptr(), w.data_ptr(), b.data_ptr(),
            out.data_ptr(), n, S, G, rows.stride(0), emb.shape[1],
            dims["k0p"], dims["hp"], dims["n_hidden"], dims["out_dim"],
            row_tile_blocks(n, _sms(rows.device.index or 0)),
            torch.cuda.current_stream(rows.device).cuda_stream)
    build.check(lib, err, "field_head kernel launch")
    count("kernel.field_head")
    return out


def field_head_cuda(directions: torch.Tensor, geo: torch.Tensor,
                    camera_indices: torch.Tensor, appearance: torch.Tensor,
                    layers, use_average_appearance: bool = False) -> torch.Tensor:
    """ops/field_head.py::field_head_plain's function in one launch, bf16
    -> rgb (..., out_dim) bf16; no gradient."""
    _check(directions, geo, camera_indices, appearance, layers)
    lead, G = geo.shape[:-1], geo.shape[-1]
    dirs, S = per_direction(directions, len(lead))
    if use_average_appearance:
        emb = cached("mean appearance", [appearance],
                     lambda: appearance.mean(dim=0)[None])
        cam = None
    else:
        cam, s_cam = per_direction(camera_indices, len(lead))
        if s_cam != S:  # the cameras do not repeat as the directions do
            dirs, S, cam = directions, 1, camera_indices
        cam = cam.reshape(-1).to(torch.int64).contiguous()
        emb = appearance.contiguous()
    rows = geo.reshape(lead.numel(), G)
    if rows.stride(1) != 1:
        rows = rows.contiguous()
    out = launch(dirs.reshape(-1, 3).contiguous(), S, rows, emb, cam, layers)
    return out.reshape(*lead, out.shape[1])
