"""Input encodings: NeRF sinusoidal PE and degree-4 spherical harmonics.

Counterpart of neraf_tpu/ops/encodings.py (nerfstudio's NeRFEncoding and the
tinycudann SH encoding the reference uses).
"""

from __future__ import annotations

import math

import torch

SH_DIM = 16  # degree-4 spherical harmonics (levels=4 -> 16 coefficients)


def nerf_encoding_dim(in_dim: int, num_frequencies: int = 10,
                      include_input: bool = True) -> int:
    return in_dim * (2 * num_frequencies + (1 if include_input else 0))


def nerf_frequencies(num_frequencies: int, min_freq_exp: float,
                     max_freq_exp: float, device=None) -> torch.Tensor:
    """The encoding's frequencies in turns: 2^linspace(min, max, F), f32."""
    return 2.0 ** torch.linspace(min_freq_exp, max_freq_exp, num_frequencies,
                                 dtype=torch.float32, device=device)


def nerf_encoding(x: torch.Tensor, num_frequencies: int = 10,
                  min_freq_exp: float = 0.0, max_freq_exp: float = 8.0,
                  include_input: bool = True) -> torch.Tensor:
    """(..., D) -> (..., 2*D*num_frequencies [+ D]).

    Layout [sin over D*F (d-major), cos over D*F, x]; cos is sin(ang + pi/2).
    """
    freqs = nerf_frequencies(num_frequencies, min_freq_exp, max_freq_exp,
                             x.device)
    ang = (2.0 * math.pi * x)[..., None] * freqs  # (..., D, F)
    ang = ang.reshape(*x.shape[:-1], -1)
    enc = torch.sin(torch.cat([ang, ang + math.pi / 2.0], dim=-1))
    if include_input:
        enc = torch.cat([enc, x], dim=-1)
    return enc


def sh_encoding(d: torch.Tensor) -> torch.Tensor:
    """(..., 3) values in [0, 1] -> (..., 16) SH coefficients (2x-1 remap)."""
    v = d * 2.0 - 1.0
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    x2, y2, z2 = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    out = [
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y,
        0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * xy,
        -1.0925484305920792 * yz,
        0.94617469575755997 * z2 - 0.31539156525251999,
        -1.0925484305920792 * xz,
        0.54627421529603959 * x2 - 0.54627421529603959 * y2,
        0.59004358992664352 * y * (-3.0 * x2 + y2),
        2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * z2),
        0.3731763325901154 * z * (5.0 * z2 - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * z2),
        1.4453057213202769 * z * (x2 - y2),
        0.59004358992664352 * x * (-x2 + 3.0 * y2),
    ]
    return torch.stack(out, dim=-1)
