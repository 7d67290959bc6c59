"""The main field's colour branch: the plain version and the kernel dispatch.

For rows r of geo features (..., G), in the field's dtype,

  sh  = SH4((directions + 1) / 2)          (f32, ops/encodings.py)
  x0  = [sh (16) | geo (G) | appearance row (E)] in f32, cast to the dtype
  h   = relu(dense(h)) over the head's hidden layers
  rgb = sigmoid(dense(h)) in the field's dtype,

the appearance row being the mean of the (C, E) table or the row of each
sample's camera. No TPU kernel stands behind it: the JAX package leaves
the chain to XLA, which fuses it; eager PyTorch runs it as ~70 launches a
render chunk. ``field_head`` runs the hand-written CUDA kernel
(csrc/field_head.cu, through ops/cuda/field_head.py) on a CUDA tensor
when no gradient is recorded and the field computes in bf16: the render,
the viewer, the eval renders and the no-grad bake sweep. Everything else
takes the plain chain, ``field_head_plain``, by what the call shows, with
no fallback between the two:
  - the CPU;
  - training, which records a gradient: the branch has no backward
    kernel, so training's colour branch stays plain PyTorch until one is
    written;
  - a float32 field on a card. The configurations compute in bf16; float32
    fields are the checks' (card against CPU). A CUDA-core f32 kernel, as
    pe_mlp keeps one, was built and timed on an H100 at a render chunk:
    11.0 ms against the plain chain's 6.4 (cuBLAS's f32 GEMMs), so it was
    not kept.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from neraf_tpu_torch.ops.encodings import SH_DIM, sh_encoding
from neraf_tpu_torch.ops.pe_mlp import dense, pack_chain, padded

HEAD_MAX_IN = 64  # the kernel's layer-0 input, SH + G + E padded to 16


def field_head_plain(directions: torch.Tensor, geo: torch.Tensor,
                     camera_indices: torch.Tensor, appearance: torch.Tensor,
                     layers, use_average_appearance: bool = False,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """directions (..., 3) unit vectors, geo (..., G), camera_indices
    (...,) ints, appearance the (C, E) embedding table, `layers` the head's
    [(W (out, in), b)] ending in the 3-wide output -> rgb (..., 3) in
    `dtype`."""
    d_enc = sh_encoding((directions + 1.0) / 2.0)
    if use_average_appearance:
        emb = appearance.mean(dim=0).expand(*geo.shape[:-1], appearance.shape[1])
    else:
        emb = F.embedding(camera_indices, appearance)
    h = torch.cat([d_enc, geo.to(torch.float32), emb], dim=-1)
    for w, b in layers[:-1]:
        h = torch.relu(dense(h, w, b, dtype))
    w, b = layers[-1]
    return torch.sigmoid(dense(h, w, b, dtype))


def pack_head(layers, dtype: torch.dtype):
    """The kernel's form of the head (pe_mlp.py::pack_chain): the hidden
    width padded to one of KERNEL_HIDDEN_WIDTHS, the input to a multiple of
    16 (k0p <= HEAD_MAX_IN) with its columns in x0's order, the output to
    8. Weights flat in `dtype`, biases flat in float32, and the dims."""
    k_in = layers[0][0].shape[1]
    k0p = -(-k_in // 16) * 16
    if k_in <= SH_DIM or k0p > HEAD_MAX_IN:
        raise ValueError(f"field_head: the head takes {k_in} inputs "
                         f"({SH_DIM + 1}..{HEAD_MAX_IN})")
    return pack_chain(layers, k0p, lambda w0, hp, k: padded(w0, (hp, k)),
                      dtype)


def field_head(directions: torch.Tensor, geo: torch.Tensor,
               camera_indices: torch.Tensor, appearance: torch.Tensor,
               layers, use_average_appearance: bool = False,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """field_head_plain's function: the kernel on a CUDA tensor with no
    gradient recorded and a bf16 field, else the plain chain."""
    inputs = [directions, geo, appearance, *(t for wb in layers for t in wb)]
    if (geo.device.type != "cuda" or dtype != torch.bfloat16
            or (torch.is_grad_enabled()
                and any(t.requires_grad for t in inputs))):
        return field_head_plain(directions, geo, camera_indices, appearance,
                                layers, use_average_appearance, dtype)
    from neraf_tpu_torch.ops.cuda.field_head import field_head_cuda

    return field_head_cuda(directions, geo, camera_indices, appearance,
                           layers, use_average_appearance)
