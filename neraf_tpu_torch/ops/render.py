"""Volume rendering (counterpart of neraf_tpu/ops/render.py): transmittance
weights, the rgb, accumulation and depth renderers over (rays, samples)
tensors, and Nerfacto's interlevel and distortion losses.
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


def _outer(t0_starts: torch.Tensor, t0_ends: torch.Tensor,
           t1_starts: torch.Tensor, t1_ends: torch.Tensor,
           y1: torch.Tensor) -> torch.Tensor:
    """Sum of the histogram y1 (over the ascending intervals t1) within each
    t0 interval (mip-NeRF-360's outer measure), (..., S0).

    The JAX package brackets with masked max/min reductions over an
    (S0, S1) comparison; with ascending edges the same elements are the
    cumulative sum at searchsorted positions: the last t1 start <= t0 start
    (none: 0) and the first t1 end >= t0 end (none: the total)."""
    cy1 = torch.cat([torch.zeros_like(y1[..., :1]), torch.cumsum(y1, dim=-1)],
                    dim=-1)
    lo = torch.searchsorted(t1_starts.contiguous(), t0_starts.contiguous(),
                            right=True)
    hi = torch.searchsorted(t1_ends.contiguous(), t0_ends.contiguous())
    cy1_lo = cy1.gather(-1, (lo - 1).clamp_min(0))
    cy1_hi = cy1.gather(-1, (hi + 1).clamp_max(y1.shape[-1]))
    return cy1_hi - cy1_lo


def interlevel_loss(weights: torch.Tensor, spacing_starts: torch.Tensor,
                    spacing_ends: torch.Tensor, prop_weights: torch.Tensor,
                    prop_starts: torch.Tensor,
                    prop_ends: torch.Tensor) -> torch.Tensor:
    """Proposal supervision: mean(clip(w - w_outer, 0)^2 / (w + eps)), the
    final weights and spacings detached (they are the targets)."""
    w = weights.detach()
    w_outer = _outer(spacing_starts.detach(), spacing_ends.detach(),
                     prop_starts, prop_ends, prop_weights)
    clipped = (w - w_outer).clamp_min(0.0)
    return torch.mean(clipped ** 2 / (w + 1e-7))


def distortion_loss(weights: torch.Tensor, spacing_starts: torch.Tensor,
                    spacing_ends: torch.Tensor) -> torch.Tensor:
    """mip-NeRF-360's distortion regulariser on spacing histograms."""
    mid = (spacing_starts + spacing_ends) / 2.0
    dt = spacing_ends - spacing_starts
    dm = torch.abs(mid[..., :, None] - mid[..., None, :])
    inner = torch.sum(weights[..., :, None] * weights[..., None, :] * dm,
                      dim=(-1, -2))
    self_term = torch.sum(weights ** 2 * dt, dim=-1) / 3.0
    return torch.mean(inner + self_term)
