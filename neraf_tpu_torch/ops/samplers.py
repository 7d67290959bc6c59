"""Ray samplers in the normalised spacing domain (counterpart of
neraf_tpu/ops/samplers.py).

A spacing s in [0, 1] maps linearly in depth over [near, mid] for s < 1/2 and
linearly in disparity over [mid, far] above. The eval path is deterministic:
fixed uniform bins, then inverse-CDF resampling at bin-centred quantiles.
Training jitters both, with one uniform per ray (use_single_jitter) or one
per bin edge, passed in explicitly: JAX's PRNG and torch's never agree, so
the caller draws.
"""

from __future__ import annotations

import torch


def _spacing_to_euclidean(s: torch.Tensor) -> torch.Tensor:
    """Piecewise lin/lindisp map: s<1/2 -> t=2s (linear), else t=1/(2(1-s))."""
    return torch.where(s < 0.5, 2.0 * s,
                       1.0 / (2.0 * (1.0 - s.clamp_max(1.0 - 1e-7))))


def _euclidean_to_spacing(t: torch.Tensor) -> torch.Tensor:
    """Inverse of _spacing_to_euclidean: t<1 -> t/2, else 1 - 1/(2t)."""
    return torch.where(t < 1.0, t / 2.0, 1.0 - 1.0 / (2.0 * t.clamp_min(1e-7)))


def spacing_bins_to_euclidean(bins_s: torch.Tensor, near: torch.Tensor,
                              far: torch.Tensor) -> torch.Tensor:
    """Map spacing-domain bins (R, S+1) to euclidean distances along the ray."""
    s_near = _euclidean_to_spacing(near)
    s_far = _euclidean_to_spacing(far)
    s = bins_s * s_far[..., None] + (1.0 - bins_s) * s_near[..., None]
    return _spacing_to_euclidean(s)


def uniform_spacing_bins(num_rays: int, num_samples: int, device=None,
                         jitter: torch.Tensor | None = None) -> torch.Tensor:
    """Uniform bins in the spacing domain -> (R, S+1) in [0, 1]. With
    `jitter` uniforms in [0, 1), (R, 1) or one per edge (R, S+1), interior
    edge i moves by (u - 1/2) / S and is clipped to [0, 1]; 0 and 1 stay.
    Per-edge uniforms: the interior edges take the first S - 1 columns, as
    the JAX package does."""
    edges = torch.linspace(0.0, 1.0, num_samples + 1, dtype=torch.float32,
                           device=device)
    bins = edges.expand(num_rays, num_samples + 1)
    if jitter is None:
        return bins
    width = 1.0 / num_samples
    if jitter.shape[-1] > 1:
        jitter = jitter[..., :num_samples - 1]
    interior = (bins[..., 1:-1] + jitter * width - width / 2.0).clamp(0.0, 1.0)
    return torch.cat([bins[..., :1], interior, bins[..., -1:]], dim=-1)


def pdf_spacing_bins(bins_s: torch.Tensor, weights: torch.Tensor,
                     num_samples: int, histogram_padding: float = 0.01,
                     jitter: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse-CDF resampling of spacing bins (R, S+1) from per-interval
    weights (R, S) at the quantiles (i + 1/2) / (num_samples + 1), or with
    `jitter` uniforms, (R, 1) or one per quantile (R, num_samples + 1), at
    (i + u_i) / (num_samples + 1) -> (R, num_samples + 1) sorted bin edges.

    The bracketing edges come from a binary search: cdf is non-decreasing,
    so searchsorted(right=True) finds the first edge with cdf > u, which is
    the edge the JAX package's masked min/max reductions select, ties at
    cdf 1.0 included.
    """
    num_bins = num_samples + 1
    eps = 1e-5
    w = weights + histogram_padding / weights.shape[-1]
    w_sum = w.sum(dim=-1, keepdim=True)
    pad = (eps - w_sum).clamp_min(0.0)
    w = w + pad / w.shape[-1]
    w_sum = w_sum + pad

    pdf = w / w_sum
    cdf = torch.cumsum(pdf[..., :-1], dim=-1).clamp_max(1.0)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf,
                     torch.ones_like(cdf[..., :1])], dim=-1)  # (R, S+1)

    u = torch.linspace(0.0, 1.0 - 1.0 / num_bins, num_bins, dtype=cdf.dtype,
                       device=cdf.device)
    u = u + (0.5 / num_bins if jitter is None else jitter / num_bins)
    u = u.expand(*cdf.shape[:-1], num_bins).contiguous()
    above = torch.searchsorted(cdf, u, right=True).clamp(1, cdf.shape[-1] - 1)
    below = above - 1
    cdf_g0, cdf_g1 = cdf.gather(-1, below), cdf.gather(-1, above)
    bins_g0, bins_g1 = bins_s.gather(-1, below), bins_s.gather(-1, above)

    denom = cdf_g1 - cdf_g0
    t = torch.where(denom > 1e-12, (u - cdf_g0) / denom,
                    torch.zeros_like(u)).clamp(0.0, 1.0)
    return bins_g0 + t * (bins_g1 - bins_g0)


def bins_to_samples(bins_s: torch.Tensor, origins: torch.Tensor,
                    directions: torch.Tensor, near: torch.Tensor,
                    far: torch.Tensor) -> dict:
    """Spacing bins -> sample positions (R,S,3), deltas, euclidean
    starts/ends/mids and spacing starts/ends (R,S)."""
    t_edges = spacing_bins_to_euclidean(bins_s, near, far)  # (R, S+1)
    starts = t_edges[..., :-1]
    ends = t_edges[..., 1:]
    mids = (starts + ends) / 2.0
    positions = origins[..., None, :] + directions[..., None, :] * mids[..., None]
    return {
        "positions": positions,
        "deltas": ends - starts,
        "starts": starts,
        "ends": ends,
        "mids": mids,
        "spacing_starts": bins_s[..., :-1],
        "spacing_ends": bins_s[..., 1:],
    }
