"""Scene grid state (counterpart of the state half of neraf_tpu/models/grid.py).

A (D*H*W, 7) grid, channels 0:3 rgb, 3 alpha, 4:7 cell xyz, flattened
C-order over (x, y, z); the ResNet reads it as an NDHWC volume. The bake from
the radiance field belongs to training and is not here.
"""

from __future__ import annotations

import numpy as np
import torch

GRID_CHANNELS = 7


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
