"""Nerfacto radiance field and proposal density fields (counterpart of
neraf_tpu/fields/nerfacto.py):

  positions --contract--> [0,1]^3 --encoding + base MLP-->
      (density_before_activation, geo_feat)
  density = average_init_density * trunc_exp(density_before_activation)
  rgb = sigmoid(head MLP(SH4(dir), geo_feat, appearance embedding))

The main field's encoding is "fourier" (fourier PE + a deep base MLP, fused
in ops/pe_mlp.py::pe_mlp) or "hash" (the multiresolution hash grid,
ops/hashgrid.py::hash_encoding, then a hidden_layers x hidden_dim ReLU
chain of `dense` layers, as the JAX field runs it with XLA). The proposal
fields are fourier (ProposalDensityField) or hash grids with one ReLU
layer (HashDensityField, nerfstudio's HashMLPDensityField, which the JAX
package cannot build). On a card pe_mlp and hash_encoding are the CUDA
kernels, on both contraction modes (the JAX package keeps its Pallas
kernel off the contract=False bake path for a TPU layout reason). The
colour branch (ops/field_head.py) is one CUDA kernel on a card when nothing
records a gradient and the field computes in bf16, else the plain chain.
Parameters are kept in float32 and each layer computes in the field's
dtype, as flax's Dense does.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch import nn

from neraf_tpu_torch.configs.config import VisionModelConfig
from neraf_tpu_torch.fields.acoustic import lecun_normal_
from neraf_tpu_torch.ops.contraction import contract_to_unit
from neraf_tpu_torch.ops.encodings import SH_DIM
from neraf_tpu_torch.ops.field_head import field_head
from neraf_tpu_torch.ops.hashgrid import HashGridSpec, hash_encoding, init_hash_table
from neraf_tpu_torch.ops.pe_mlp import dense, pe_mlp
from neraf_tpu_torch.utils.profiling import span
from neraf_tpu_torch.utils.weight_cache import cached


class TruncExp(torch.autograd.Function):
    """exp with a clamped-input gradient (instant-NGP trunc_exp)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(-15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return TruncExp.apply(x)


def _reset_dense(layers, generator):
    """flax Dense defaults: lecun_normal kernels, zero biases."""
    for lin in layers:
        lecun_normal_(lin.weight, generator)
        nn.init.zeros_(lin.bias)


def _pe_mlp_nd(x: torch.Tensor, layers, num_frequencies: int,
               dtype: torch.dtype) -> torch.Tensor:
    """pe_mlp over (..., 3) positions -> (..., O) float32."""
    flat = x.reshape(-1, 3).to(torch.float32).contiguous()
    h = pe_mlp(flat, layers, num_frequencies, 0.0, 8.0, dtype)
    return h.reshape(*x.shape[:-1], h.shape[-1])


def _density(h: torch.Tensor, x: torch.Tensor, scale: float,
             masked: bool) -> torch.Tensor:
    """scale * trunc_exp(h's first output) in float32 -> (...,); where
    `masked`, zero at the points x outside the open cube (0, 1)^3."""
    density = scale * trunc_exp(h[..., 0].to(torch.float32))
    if masked:
        density = density * torch.all((x > 0.0) & (x < 1.0), dim=-1)
    return density


def hash_density(grid: nn.Module, layers, x: torch.Tensor, scale: float,
                 masked: bool, dtype: torch.dtype, spans=(None, None)):
    """Both hash fields' density path: grid(x), then the `dense` layers
    ((weight, bias) pairs, a ReLU between two) in `dtype`, then _density ->
    (density (...,) f32, the last layer's output (..., O) in dtype). Inside
    a weights_fixed() scope (an image's chunks, a bake sweep) the layers
    are cast to dtype once. `spans`: the tracer's names for the grid and for
    the rest, or None for no span."""
    enc, rest = (span(s) if s else contextlib.nullcontext() for s in spans)
    params = [t for wb in layers for t in wb]
    with enc:
        h = grid(x)
    with rest:
        cast = cached("hash field layers", params,
                      lambda: [t.to(dtype) for t in params])
        for i in range(0, len(cast), 2):
            if i:  # rebound, so that the layer's input is freed before the next
                h = torch.relu(h)
            h = dense(h, cast[i], cast[i + 1], dtype)
        return _density(h, x, scale, masked), h


class HashTable(nn.Module):
    """The hash grid's (L, T, F) float32 feature table as a parameter."""

    def __init__(self, spec: HashGridSpec):
        super().__init__()
        self.spec = spec
        self.table = nn.Parameter(init_hash_table(spec))

    def reset_parameters(self, generator: torch.Generator | None = None):
        with torch.no_grad():
            self.table.copy_(init_hash_table(self.spec, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(..., 3) points in [0, 1] -> (..., L*F) float32."""
        return hash_encoding(self.table, x, self.spec)


class NerfactoField(nn.Module):
    """Main radiance field, fourier or hash encoding."""

    def __init__(self, config: VisionModelConfig, num_cameras: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        if config.encoding == "hash":
            self.hash = HashTable(HashGridSpec(
                num_levels=config.num_levels,
                features_per_level=config.features_per_level,
                log2_hashmap_size=config.log2_hashmap_size,
                base_res=config.base_res, max_res=config.max_res,
                grad_mode=config.hash_grad_mode))
            width, layers = config.hidden_dim, config.hidden_layers
            enc_dim = self.hash.spec.out_dim
        elif config.encoding == "fourier":
            width, layers = config.base_mlp_width, config.base_mlp_layers
            enc_dim = 6 * config.num_frequencies + 3
        else:
            raise ValueError(f"encoding={config.encoding!r}: 'fourier' or "
                             "'hash'")
        in_dims = [enc_dim] + [width] * (layers - 1)
        self.mlp_base = nn.ModuleList(nn.Linear(d, width) for d in in_dims)
        self.base_out = nn.Linear(width, 1 + config.geo_feat_dim)
        head_in = SH_DIM + config.geo_feat_dim + config.appearance_embed_dim
        hc = config.hidden_dim_color
        self.mlp_head = nn.ModuleList(
            nn.Linear(d, hc)
            for d in [head_in] + [hc] * (config.hidden_layers_color - 1))
        self.head_out = nn.Linear(hc, 3)
        self.appearance = nn.Embedding(num_cameras, config.appearance_embed_dim)

    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax's initialisers: lecun_normal Dense kernels, zero biases,
        nn.Embed's normal(0, 1/sqrt(features)) table, and the hash table's
        uniform(-1e-4, 1e-4)."""
        _reset_dense([*self.mlp_base, self.base_out, *self.mlp_head,
                      self.head_out], generator)
        nn.init.normal_(self.appearance.weight, 0.0,
                        1.0 / math.sqrt(self.appearance.embedding_dim),
                        generator=generator)
        if self.config.encoding == "hash":
            self.hash.reset_parameters(generator)

    def base_layers(self):
        return [(lin.weight, lin.bias) for lin in (*self.mlp_base, self.base_out)]

    def density_and_features(self, positions: torch.Tensor,
                             contract: bool = True):
        """positions (..., 3) world -> density (..., 1) f32, geo (..., G).

        contract=True: scene contraction into [0,1]^3; contract=False: the
        [-1,1] scene box into [0,1]^3, with zero density outside it.
        """
        x = contract_to_unit(positions) if contract else (positions + 1.0) / 2.0
        scale = self.config.average_init_density
        if self.config.encoding == "hash":
            density, h = hash_density(self.hash, self.base_layers(), x, scale,
                                      not contract, self.dtype)
        else:
            h = _pe_mlp_nd(x, self.base_layers(), self.config.num_frequencies,
                           self.dtype).to(self.dtype)
            density = _density(h, x, scale, not contract)
        return density[..., None], h[..., 1:]

    def head_layers(self):
        return [(lin.weight, lin.bias) for lin in (*self.mlp_head, self.head_out)]

    def rgb_from_features(self, directions: torch.Tensor, geo: torch.Tensor,
                          camera_indices: torch.Tensor,
                          use_average_appearance: bool = False) -> torch.Tensor:
        """directions (..., 3) unit vectors, camera_indices (...,) ints
        (ops/field_head.py: the kernel when nothing records a gradient on
        a bf16 field on a card, else the plain chain)."""
        return field_head(directions, geo, camera_indices,
                          self.appearance.weight, self.head_layers(),
                          use_average_appearance, self.dtype)

    def forward(self, positions, directions, camera_indices,
                contract: bool = True, use_average_appearance: bool = False):
        density, geo = self.density_and_features(positions, contract)
        rgb = self.rgb_from_features(directions, geo, camera_indices,
                                     use_average_appearance)
        return {"density": density[..., 0], "rgb": rgb}


class ProposalDensityField(nn.Module):
    """Density-only fourier PE + MLP field for hierarchical sampling (the
    JAX package's ProposalFieldSpec defaults: F 6, 2 x 128)."""

    def __init__(self, num_frequencies: int = 6, mlp_width: int = 128,
                 mlp_layers: int = 2, average_init_density: float = 0.01,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_frequencies = num_frequencies
        self.average_init_density = average_init_density
        self.dtype = dtype
        dims = [6 * num_frequencies + 3] + [mlp_width] * mlp_layers + [1]
        self.mlp = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def reset_parameters(self, generator: torch.Generator | None = None):
        _reset_dense(self.mlp, generator)

    def forward(self, positions: torch.Tensor,
                contract: bool = True) -> torch.Tensor:
        """positions (..., 3) -> densities (...,) f32."""
        x = contract_to_unit(positions) if contract else positions
        h = _pe_mlp_nd(x, [(lin.weight, lin.bias) for lin in self.mlp],
                       self.num_frequencies, self.dtype)
        return self.average_init_density * trunc_exp(h[..., 0])


class HashDensityField(nn.Module):
    """nerfstudio's HashMLPDensityField, as Nerfacto's proposal networks
    build it: positions contracted into [0, 1]^3 (or taken as they are),
    the hash grid of `spec`, one ReLU layer of hidden_dim, a 1-wide output;
    density = average_init_density * trunc_exp(output), zero where a
    point lies outside the open cube (0, 1)^3 (hash_density, the main hash
    field's path too). nerfstudio also zeroes such a point's position
    before the grid; its density is zeroed all the same, so neither the
    density nor any gradient differs. Spans vision.proposal_encoding (the
    grid) and vision.proposal_mlp (the layers, trunc_exp and the mask)."""

    def __init__(self, spec: HashGridSpec, hidden_dim: int = 16,
                 average_init_density: float = 0.01,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.average_init_density = average_init_density
        self.dtype = dtype
        self.hash = HashTable(spec)
        self.mlp = nn.ModuleList([nn.Linear(spec.out_dim, hidden_dim),
                                  nn.Linear(hidden_dim, 1)])

    def reset_parameters(self, generator: torch.Generator | None = None):
        _reset_dense(self.mlp, generator)
        self.hash.reset_parameters(generator)

    def forward(self, positions: torch.Tensor,
                contract: bool = True) -> torch.Tensor:
        """positions (..., 3) -> densities (...,) f32."""
        x = contract_to_unit(positions) if contract else positions
        density, _ = hash_density(
            self.hash, [(lin.weight, lin.bias) for lin in self.mlp], x,
            self.average_init_density, True, self.dtype,
            ("vision.proposal_encoding", "vision.proposal_mlp"))
        return density
