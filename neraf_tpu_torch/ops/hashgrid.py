"""Multiresolution hash-grid encoding (instant-NGP), the plain version and
the kernel dispatch (counterpart of neraf_tpu/ops/hashgrid.py).

L resolution levels, geometric from base_res to max_res, each backed by a
table of T = 2^log2_hashmap_size rows of F features. A point in [0, 1]^3
trilinearly interpolates the 8 grid corners around it on every level, and
the levels' features are concatenated, level-major. Coarse levels whose
(res + 1)^3 corners fit the table index it densely (collision-free); fine
levels use the instant-NGP XOR-prime spatial hash, in uint32, mod T.

``hash_encoding`` runs the plain version for a CPU tensor (differentiated by
autograd: the table's gradient is index_select's backward, an index_add_,
the "scatter" VJP that the JAX package picks off the TPU) and the
hand-written CUDA kernels for a CUDA tensor (csrc/hash_encoding.cu through
ops/cuda/hash_encoding.py), with no fallback between them. The JAX
package's sort-based, scatter-free table gradients exist only because the
TPU's scatter-add crashed, and are not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# instant-NGP spatial hash primes (pi_1 = 1 keeps x contiguous)
PRIMES = (1, 2654435761, 805459861)
# the 8 corner offsets (i, j, k) of a cell, in the reference's order
CORNERS = tuple((i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1))
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class HashGridSpec:
    """Static configuration of a multiresolution hash encoding.

    grad_mode is the JAX package's table-gradient strategy; it is kept so
    that a spec means the same grid in both packages and has no effect in
    the port (the CPU runs autograd's scatter, the card atomic adds).
    """

    num_levels: int = 16
    features_per_level: int = 2
    log2_hashmap_size: int = 19
    base_res: int = 16
    max_res: int = 2048
    grad_mode: str = "auto"

    @property
    def table_size(self) -> int:
        return 1 << self.log2_hashmap_size

    @property
    def out_dim(self) -> int:
        return self.num_levels * self.features_per_level

    @property
    def growth_factor(self) -> float:
        if self.num_levels == 1:
            return 1.0
        return float(
            np.exp((np.log(self.max_res) - np.log(self.base_res)) / (self.num_levels - 1))
        )

    def resolutions(self) -> np.ndarray:
        """(L,) int32 grid resolutions: floor(base * growth^l) in float64, as
        the reference computes them (with a non-integer growth, floor decides
        the grid)."""
        lvl = np.arange(self.num_levels)
        return np.floor(self.base_res * self.growth_factor**lvl).astype(np.int32)

    def dense_levels(self) -> np.ndarray:
        """(L,) bool: the levels whose (res + 1)^3 corners fit the table."""
        res = self.resolutions().astype(np.int64)
        return (res + 1) ** 3 <= self.table_size


def init_hash_table(spec: HashGridSpec,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """(L, T, F) float32 drawn from uniform(-1e-4, 1e-4), as instant-NGP and
    the reference initialise it."""
    shape = (spec.num_levels, spec.table_size, spec.features_per_level)
    return torch.empty(shape, dtype=torch.float32).uniform_(
        -1e-4, 1e-4, generator=generator)


def clip_unit(x: torch.Tensor) -> torch.Tensor:
    """clip(x, 0, 1) with jnp.clip's gradient: 1 inside, 0 outside and 1/2
    at exactly 0 or 1 (torch.minimum/maximum split a tie as lax.max does;
    torch.clamp would pass all of it)."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def hash_corners(xf: torch.Tensor, spec: HashGridSpec):
    """Clipped points xf (B, 3) f32 -> the rows of the flat (L*T, F) table
    their corners read, (L, B, 8) int64, and the trilinear weights,
    (L, B, 8) f32 (differentiable in xf)."""
    res_np = spec.resolutions()
    dev = xf.device
    res = torch.as_tensor(res_np, device=dev)
    pos = xf[None] * res.to(xf.dtype)[:, None, None]  # (L, B, 3)
    c0 = torch.floor(pos)
    frac = pos - c0
    corners = torch.tensor(CORNERS, device=dev)  # (8, 3)
    cidx = torch.minimum(c0.detach().long()[:, :, None, :] + corners,
                         res[:, None, None, None].long())  # (L, B, 8, 3)
    stride = (res.long() + 1)[:, None, None]
    dense_idx = cidx[..., 0] + cidx[..., 1] * stride + cidx[..., 2] * stride * stride
    hashed = ((cidx[..., 0] * PRIMES[0]) & _U32) ^ ((cidx[..., 1] * PRIMES[1]) & _U32)
    hashed = (hashed ^ ((cidx[..., 2] * PRIMES[2]) & _U32)) & (spec.table_size - 1)
    dense = torch.as_tensor(spec.dense_levels(), device=dev)[:, None, None]
    offset = torch.arange(spec.num_levels, device=dev)[:, None, None] * spec.table_size
    rows = torch.where(dense, dense_idx, hashed) + offset
    w = torch.where(corners.bool(), frac[:, :, None, :], 1.0 - frac[:, :, None, :])
    weights = w[..., 0] * w[..., 1] * w[..., 2]  # x, y, z
    return rows, weights


def hash_encoding_plain(table: torch.Tensor, x: torch.Tensor,
                        spec: HashGridSpec) -> torch.Tensor:
    """table (L, T, F), x (..., 3) positions in [0, 1] (outside clamps) ->
    (..., L*F) float32, level-major."""
    lead = x.shape[:-1]
    xf = clip_unit(x.reshape(-1, 3))
    B, L, F = xf.shape[0], spec.num_levels, spec.features_per_level
    rows, weights = hash_corners(xf, spec)
    feats = table.reshape(-1, F).index_select(0, rows.reshape(-1))
    feats = feats.reshape(L, B, 8, F).double()
    w64 = weights.double()
    # fma(feature, weight, sum) in float32 over the corners in order, as
    # XLA's CPU reduction forms it (bitwise) and the kernel does: the
    # product of two float32s is exact in float64, so one rounding a corner
    out = torch.zeros((L, B, F), dtype=torch.float32, device=x.device)
    for c in range(8):
        out = (feats[:, :, c] * w64[:, :, c, None] + out.double()).float()
    return out.permute(1, 0, 2).reshape(*lead, L * F)


def bwd_atomics(x: torch.Tensor, spec: HashGridSpec, warp: int = 32) -> dict:
    """What the backward kernel (csrc/hash_encoding.cu) adds into the table
    gradient for the points x (..., 3), counted from the points alone, with
    warps of `warp` consecutive rows:

    - "scalar": 8 L F float atomics a row, one a feature of each corner, as
      a kernel without grouping or vector atomics would make;
    - "aggregated": the kernel's vector atomics: a warp's rows whose point
      lies in one cell of a level form a group, which adds once a corner,
      so 8 for each distinct (warp, level, cell);
    - "distinct": the distinct (warp, level, table row) triples, the least
      that any grouping could make.
    """
    xf = clip_unit(x.reshape(-1, 3).float())
    rows, _ = hash_corners(xf, spec)  # (L, B, 8), each level's rows apart
    L, B = rows.shape[:2]
    dev = rows.device
    res = torch.as_tensor(spec.resolutions(), device=dev)
    c0 = torch.floor(xf[None] * res.to(xf.dtype)[:, None, None]).long()
    st = (res.long() + 1)[:, None]
    cells = c0[..., 0] + c0[..., 1] * st + c0[..., 2] * st * st  # (L, B)
    n_cells = int(st.max()) ** 3
    wid = torch.arange(B, device=dev) // warp
    if (int(wid[-1]) + 1) * L * n_cells >= 2**63:
        raise ValueError(f"bwd_atomics: {B} rows at {n_cells} cells a level "
                         "overflow the int64 keys")
    lvl = torch.arange(L, device=dev)[:, None]
    per_cell = (wid * L + lvl) * n_cells + cells  # (L, B)
    per_row = wid[:, None] * (L * spec.table_size) + rows  # (L, B, 8)
    return {
        "scalar": 8 * L * spec.features_per_level * B,
        "aggregated": 8 * int(torch.unique(per_cell).numel()),
        "distinct": int(torch.unique(per_row).numel()),
    }


def fwd_sectors(x: torch.Tensor, spec: HashGridSpec, warp: int = 32) -> list:
    """The L2 sector requests of the forward kernel's gathers for the points
    x (..., 3), counted from the points alone: a warp's load of one corner
    on one level asks once for each distinct 32-byte sector that its rows'
    table rows lie in (32 / (4 F) rows a sector) -> for each level, the
    distinct (warp, corner, sector) triples."""
    xf = clip_unit(x.reshape(-1, 3).float())
    rows, _ = hash_corners(xf, spec)  # (L, B, 8), each level's rows apart
    L, B = rows.shape[:2]
    sectors = rows // (32 // (4 * spec.features_per_level))
    n_sectors = int(sectors.max()) + 1
    wid = torch.arange(B, device=rows.device) // warp
    corner = torch.arange(8, device=rows.device)
    key = (wid[:, None] * 8 + corner) * n_sectors + sectors  # (L, B, 8)
    return [int(torch.unique(key[l]).numel()) for l in range(L)]


def hash_encoding(table: torch.Tensor, x: torch.Tensor,
                  spec: HashGridSpec) -> torch.Tensor:
    """The hash encoding: the plain version for a CPU tensor, the CUDA
    kernels for a CUDA tensor (or it raises)."""
    from neraf_tpu_torch.ops.cuda.hash_encoding import hash_encoding_cuda

    return hash_encoding_cuda(table, x, spec)
