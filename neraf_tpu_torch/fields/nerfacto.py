"""Nerfacto radiance field and proposal density fields (counterpart of
neraf_tpu/fields/nerfacto.py):

  positions --contract--> [0,1]^3 --encoding + base MLP-->
      (density_before_activation, geo_feat)
  density = average_init_density * trunc_exp(density_before_activation)
  rgb = sigmoid(head MLP(SH4(dir), geo_feat, appearance embedding))

The main field's encoding is "fourier" (fourier PE + a deep base MLP, fused
in ops/pe_mlp.py::pe_mlp) or "hash" (the multiresolution hash grid,
ops/hashgrid.py::hash_encoding, then a 2 x hidden_dim ReLU chain of `dense`
layers, as the JAX field runs it with XLA). The proposal fields are fourier
only. On a card pe_mlp and hash_encoding are the CUDA kernels, on both
contraction modes (the JAX package keeps its Pallas kernel off the
contract=False bake path for a TPU layout reason). The colour branch
(ops/field_head.py) is one CUDA kernel on a card when nothing records a
gradient and the field computes in bf16, else the plain chain. Parameters
are kept in float32 and each layer computes in the field's dtype, as
flax's Dense does.
"""

from __future__ import annotations

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
            width, layers = config.hidden_dim, 2
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
            nn.Linear(d, hc) for d in (head_in, hc, hc))
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
        if contract:
            x, selector = contract_to_unit(positions), None
        else:
            x = (positions + 1.0) / 2.0
            selector = torch.all((x > 0.0) & (x < 1.0), dim=-1)
        if self.config.encoding == "hash":
            h = self.hash(x)
            for lin in self.mlp_base:
                h = torch.relu(dense(h, lin.weight, lin.bias, self.dtype))
            h = dense(h, self.base_out.weight, self.base_out.bias, self.dtype)
        else:
            h = _pe_mlp_nd(x, self.base_layers(), self.config.num_frequencies,
                           self.dtype).to(self.dtype)
        density = self.config.average_init_density * trunc_exp(
            h[..., :1].to(torch.float32))
        if selector is not None:
            density = density * selector[..., None]
        return density, h[..., 1:]

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
