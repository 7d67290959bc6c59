"""Scene grid and its bake from the radiance field (counterpart of
neraf_tpu/models/grid.py:34-107, 193-205).

A (D*H*W, 7) grid, channels 0:3 rgb, 3 alpha, 4:7 cell xyz, flattened
C-order over (x, y, z); the ResNet reads it as an NDHWC volume. Every
training step refreshes `cells_per_step` cells at the cursor: each is the
mean of the radiance field queried along the viewing directions, with
alpha = clip(1 - exp(-1e-2 density), 0, 1). The carried grid is a constant
and the fresh cells are spliced in live, so the audio loss reaches the
field only through this step's cells. The JAX package's pre-folded s2d
grid (a TPU layout device) is not ported: the direct stem reads this grid.
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
