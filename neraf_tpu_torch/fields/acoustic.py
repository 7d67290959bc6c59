"""Neural acoustic sound field (counterpart of neraf_tpu/fields/acoustic.py).

Maps an encoded (scene feature, time, mic pose, source pose, orientation)
query to one STFT frame of per-channel log-magnitudes: Linear layers
in -> 5096 -> 2048 -> 1024 -> 1024 -> W, each followed by LeakyReLU(0.1), then
one Linear(W, n_freq) head per channel with tanh(h) * 10.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

TRUNK_WIDTHS = (5096, 2048, 1024, 1024)


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator | None = None):
    """flax's lecun_normal on a torch (out, in) weight: truncated normal at
    +-2 std, std = sqrt(1 / fan_in) / 0.8796... (the truncation's correction)."""
    std = math.sqrt(1.0 / weight.shape[1]) / 0.87962566103423978
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


class AcousticSoundField(nn.Module):
    """MLP sound field: (B, in_dim) -> (B, sound_rez, n_frequencies)."""

    def __init__(self, in_dim: int, hidden_w: int = 512, sound_rez: int = 2,
                 n_frequencies: int = 257):
        super().__init__()
        widths = (in_dim, *TRUNK_WIDTHS, hidden_w)
        self.trunk = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.heads = nn.ModuleList(
            nn.Linear(hidden_w, n_frequencies) for _ in range(sound_rez))

    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax Dense defaults: lecun_normal kernels, zero biases."""
        for lin in (*self.trunk, *self.heads):
            lecun_normal_(lin.weight, generator)
            nn.init.zeros_(lin.bias)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = h.to(self.trunk[0].weight.dtype)
        for lin in self.trunk:
            h = F.leaky_relu(lin(h), negative_slope=0.1)
        return torch.stack([torch.tanh(head(h)) * 10.0 for head in self.heads],
                           dim=-2)
