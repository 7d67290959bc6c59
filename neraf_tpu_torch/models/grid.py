"""Scene grid and its bake from the radiance field (counterpart of
neraf_tpu/models/grid.py).

A (D*H*W, 7) grid, channels 0:3 rgb, 3 alpha, 4:7 cell xyz, flattened
C-order over (x, y, z); the ResNet reads it as an NDHWC volume. Every
training step refreshes `cells_per_step` cells at the cursor: each is the
mean of the radiance field queried along the viewing directions, with
alpha = clip(1 - exp(-1e-2 density), 0, 1). The carried grid is a constant
and the fresh cells are spliced in live, so the audio loss reaches the
field only through this step's cells.

The ResNet's stem reads the grid space-to-depth folded: each 2^3 block of
cells becomes one voxel of 8 x 7 channels in (fd, fh, fw, c) order
(fold_volume). The joint step keeps a folded copy of the grid in the
ResNet's compute dtype and splices each step's cells into it as one slab
(folded_slab, bake_cells_folded), so that neither the fold of the whole
grid nor its input gradient runs in the step; the flat grid stays the
checkpointed state and the folded copy is derived from it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

GRID_CHANNELS = 7
_DELTA = 1e-2  # alpha = 1 - exp(-_DELTA * density)


def single_viewing_direction(device=None) -> torch.Tensor:
    """use_multiple_viewing_directions=False: one +x query direction."""
    return torch.tensor([[1.0, 0.0, 0.0]], dtype=torch.float32, device=device)


def fixed_viewing_directions(device=None) -> torch.Tensor:
    """The reference's 18 directions, 3 elevations x 6 azimuths, with its
    quirk kept: the x and y components are both cos(phi) sin(theta)."""
    dirs = [[math.cos(phi) * math.sin(theta), math.cos(phi) * math.sin(theta),
             math.sin(theta)]
            for phi in (math.pi / 3, 0.0, -math.pi)
            for theta in (k * math.pi / 3 for k in range(6))]
    return torch.tensor(dirs, dtype=torch.float32, device=device)


def cell_centers(grid_res: int) -> np.ndarray:
    """Unit-cube cell centers, flattened C-order over (x, y, z) -> (N, 3)."""
    step = 1.0 / grid_res
    axis = np.arange(step / 2, 1.0, step)
    gx, gy, gz = np.meshgrid(axis, axis, axis, indexing="ij")
    return np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float32)


def init_grid(grid_res: int, device=None) -> torch.Tensor:
    """Zeroed (N_cells, 7) grid with channels 4:7 = cell coordinates."""
    cells = cell_centers(grid_res)
    grid = np.zeros((cells.shape[0], GRID_CHANNELS), dtype=np.float32)
    grid[:, 4:] = cells
    return torch.as_tensor(grid, device=device)


def grid_to_volume(grid_flat: torch.Tensor, grid_res: int) -> torch.Tensor:
    """(N_cells, 7) -> (1, D, H, W, 7) NDHWC volume for the ResNet."""
    return grid_flat.reshape(1, grid_res, grid_res, grid_res, GRID_CHANNELS)


def compute_fresh_cells(query_fn, cursor: int, cells: torch.Tensor,
                        aabb: torch.Tensor, cells_per_step: int,
                        view_dirs: torch.Tensor) -> torch.Tensor:
    """One cursor batch of cells through query_fn (positions (B, 3),
    directions (B, 3)) -> (rgb (B, 3), density (B,)), averaged over the
    viewing directions -> (cells_per_step, 4) rgb + alpha, differentiable
    in whatever query_fn closes over."""
    batch = cells[cursor:cursor + cells_per_step]
    world = batch * (aabb[1] - aabb[0]) + aabb[0]
    n_dirs = view_dirs.shape[0]
    pos = world[None].expand(n_dirs, cells_per_step, 3).reshape(-1, 3)
    dirs = view_dirs[:, None].expand(n_dirs, cells_per_step, 3).reshape(-1, 3)
    rgb, density = query_fn(pos, dirs)
    rgb = rgb.float().reshape(n_dirs, cells_per_step, 3).mean(dim=0)
    density = density.float().reshape(n_dirs, cells_per_step).mean(dim=0)
    alpha = (1.0 - torch.exp(-_DELTA * density)).clamp(0.0, 1.0)
    return torch.cat([rgb, alpha[:, None]], dim=-1)


def bake_cells(grid: torch.Tensor, cursor: int, fresh: torch.Tensor):
    """Splice the fresh cells' rgb + alpha into a detached copy of the grid
    at the cursor -> (grid, next cursor, wrapping). The returned grid
    carries a gradient only through `fresh`."""
    out = grid.detach().clone()
    out[cursor:cursor + fresh.shape[0], :4] = fresh.to(out.dtype)
    return out, (cursor + fresh.shape[0]) % grid.shape[0]


def fold_volume(vol: torch.Tensor, dtype=None) -> torch.Tensor:
    """Space-to-depth fold (N, D, H, W, C) -> (N, D/2, H/2, W/2, 8C), the
    folded channels in (fd, fh, fw, c) order: the layout the ResNet's s2d
    stem reads. Cast to `dtype` first, so that the relayout moves the
    narrower type."""
    n, d, h, w, c = vol.shape
    x = vol if dtype is None else vol.to(dtype)
    x = x.reshape(n, d // 2, 2, h // 2, 2, w // 2, 2, c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(
        n, d // 2, h // 2, w // 2, 8 * c)


def unfold_volume(folded: torch.Tensor) -> torch.Tensor:
    """Inverse of fold_volume: (N, D2, H2, W2, 8C) -> (N, 2 D2, 2 H2, 2 W2, C)."""
    n, d2, h2, w2, c8 = folded.shape
    c = c8 // 8
    x = folded.reshape(n, d2, h2, w2, 2, 2, 2, c)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(n, 2 * d2, 2 * h2,
                                                     2 * w2, c)


def fold_grid(grid_flat: torch.Tensor, grid_res: int, dtype=None) -> torch.Tensor:
    """(N_cells, 7) flat grid -> folded (1, R/2, R/2, R/2, 56) volume."""
    return fold_volume(grid_to_volume(grid_flat, grid_res), dtype)


def folded_bake_supported(grid_res: int, cells_per_step: int) -> bool:
    """Whether one cursor batch is ONE slab of the folded volume: the batch
    covers whole z-rows in pairs of y (cells_per_step % 2R == 0) and never
    crosses an x-plane (R^2 % cells_per_step == 0). R 128 at 4096 cells a
    step qualifies."""
    return (grid_res % 2 == 0
            and cells_per_step % (2 * grid_res) == 0
            and grid_res ** 2 % cells_per_step == 0)


def folded_slab(fresh: torch.Tensor, cursor: int, cells: torch.Tensor,
                grid_res: int, dtype):
    """One cursor batch of fresh cells (B, 4) as its slab of the folded
    volume -> (slab (1, 1, B/2R, R/2, 28), d0, h0, ch_off).

    The batch [cursor, cursor + B) is x = cursor / R^2, y in [y0, y0 +
    B/R), every z: in folded coordinates depth x // 2, rows from y0 // 2,
    channels from (x % 2) 28 (needs folded_bake_supported(R, B)). The slab
    is fresh's rgb + alpha beside the cells' xyz, cast to `dtype`; it
    carries fresh's gradient (the xyz channels have none)."""
    r, b = grid_res, fresh.shape[0]
    ny = b // r
    xyz = cells[cursor:cursor + b]
    full = torch.cat([fresh, xyz.to(fresh.dtype)], dim=-1).to(dtype)  # (B, 7)
    # (y, z) C-order -> (h2, w2, fh fw c): y = 2 hh + fh, z = 2 ww + fw
    slab = full.reshape(ny // 2, 2, r // 2, 2, GRID_CHANNELS)
    slab = slab.permute(0, 2, 1, 3, 4).reshape(1, 1, ny // 2, r // 2,
                                               4 * GRID_CHANNELS)
    x_plane, y0 = cursor // (r * r), (cursor % (r * r)) // r
    return slab, x_plane // 2, y0 // 2, (x_plane % 2) * 4 * GRID_CHANNELS


def bake_cells_folded(folded: torch.Tensor, cursor: int, fresh: torch.Tensor,
                      cells: torch.Tensor, grid_res: int):
    """Splice one cursor batch of fresh cells into the folded grid, in
    place and without a gradient -> folded_slab's (slab, d0, h0, ch_off),
    the slab live. The folded volume holds the same values as
    neraf_tpu/models/grid.py::bake_cells_folded returns; the gradient
    reaches `fresh` only through the returned slab (ops/baked_stem.py)."""
    slab, d0, h0, ch = folded_slab(fresh, cursor, cells, grid_res,
                                   folded.dtype)
    with torch.no_grad():
        folded[0, d0, h0:h0 + slab.shape[2], :, ch:ch + slab.shape[4]] = slab[0, 0]
    return slab, d0, h0, ch
