"""Volume rendering (counterpart of neraf_tpu/ops/render.py, eval half):
transmittance weights, and the rgb, accumulation and depth renderers over
(rays, samples) tensors. The interlevel and distortion losses come with the
training slice.
"""

from __future__ import annotations

import torch


def render_weights(densities: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """w_i = T_i (1 - exp(-sigma_i delta_i)), T_i = exp(-sum_{j<i} sigma_j delta_j)
    over (..., S) densities and segment lengths."""
    delta_density = densities * deltas
    alphas = 1.0 - torch.exp(-delta_density)
    accum = torch.cumsum(delta_density, dim=-1)
    accum = torch.cat([torch.zeros_like(accum[..., :1]), accum[..., :-1]], dim=-1)
    return alphas * torch.exp(-accum)


def render_rgb(rgb: torch.Tensor, weights: torch.Tensor,
               background_color: str = "last_sample") -> torch.Tensor:
    """Composite (..., S, 3) rgb with (..., S) weights; the remainder of the
    opacity takes the background."""
    comp = torch.sum(weights[..., None] * rgb, dim=-2)
    acc = torch.sum(weights, dim=-1, keepdim=True)
    if background_color == "last_sample":
        bg = rgb[..., -1, :]
    elif background_color == "white":
        bg = torch.ones_like(comp)
    elif background_color == "black":
        bg = torch.zeros_like(comp)
    else:
        raise ValueError(background_color)
    return comp + bg * (1.0 - acc)


def render_accumulation(weights: torch.Tensor) -> torch.Tensor:
    """(..., S) -> (...,) total opacity."""
    return torch.sum(weights, dim=-1)


def render_depth(weights: torch.Tensor, steps: torch.Tensor,
                 method: str = "median") -> torch.Tensor:
    """'median': the first step where the cumulative weight reaches 0.5;
    'expected': the weight-averaged step."""
    if method == "expected":
        return torch.sum(weights * steps, dim=-1) / (
            torch.sum(weights, dim=-1) + 1e-10)
    cum = torch.cumsum(weights, dim=-1)
    split = torch.full_like(cum[..., :1], 0.5)
    idx = torch.searchsorted(cum, split).clamp(0, steps.shape[-1] - 1)
    return steps.gather(-1, idx)[..., 0]
