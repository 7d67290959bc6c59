"""Acoustic-field model: query encoding, forward, full-RIR sweep.

Counterpart of neraf_tpu/models/audio.py (inference half): poses normalised
into the audio AABB with out-of-box zeroing, NeRF PE of time and positions,
SH-4 of the orientation, the scene-grid descriptor concatenated first, and the
all-time-bins sweep of N RIRs as one flat (N*T) query batch.
"""

from __future__ import annotations

import torch
from torch import nn

from neraf_tpu.configs.config import AudioModelConfig
from neraf_tpu_torch.fields.acoustic import AcousticSoundField
from neraf_tpu_torch.ops.encodings import (
    SH_DIM,
    nerf_encoding,
    nerf_encoding_dim,
    sh_encoding,
)

TIME_ENC_DIM = nerf_encoding_dim(1, 10)  # 21
POS_ENC_DIM = nerf_encoding_dim(3, 10)  # 63


def normalize_positions(pos: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    """Positions into the unit box; anything not strictly inside is zeroed."""
    norm = (pos - aabb[0]) / (aabb[1] - aabb[0])
    selector = torch.all((norm > 0.0) & (norm < 1.0), dim=-1)
    return norm * selector[..., None]


def encode_query(mic_pose: torch.Tensor, source_pose: torch.Tensor,
                 rot: torch.Tensor, time_query: torch.Tensor,
                 aabb: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B, 21+63+63+16) encoded pose/time query; time_query is (B,) ints."""
    t = time_query.to(torch.float32)[..., None] / float(max_len - 1.0)
    return torch.cat([
        nerf_encoding(t),
        nerf_encoding(normalize_positions(mic_pose, aabb)),
        nerf_encoding(normalize_positions(source_pose, aabb)),
        sh_encoding(rot),
    ], dim=-1)


class AudioModel(nn.Module):
    """The acoustic field with its query encoding; grid_feature_dim is 0
    when the model is not grid-conditioned."""

    def __init__(self, config: AudioModelConfig, grid_feature_dim: int = 0):
        super().__init__()
        self.config = config
        self.grid_feature_dim = grid_feature_dim
        self.field = AcousticSoundField(
            self.in_dim, hidden_w=config.w_field, sound_rez=config.mic_ch,
            n_frequencies=config.n_freq_stft)

    @property
    def in_dim(self) -> int:
        return self.grid_feature_dim + TIME_ENC_DIM + 2 * POS_ENC_DIM + SH_DIM

    def forward(self, batch: dict, aabb: torch.Tensor,
                grid_feature: torch.Tensor | None = None) -> torch.Tensor:
        """Counterpart of AudioModel.apply: a batch of STFT-slice queries
        (time_query (B,), mic_pose/source_pose/rot (B, 3)) -> (B, C, F)."""
        h = encode_query(batch["mic_pose"], batch["source_pose"], batch["rot"],
                         batch["time_query"], aabb, self.config.max_len)
        if self.grid_feature_dim:
            if grid_feature is None:
                raise ValueError("grid-conditioned model needs grid_feature")
            feat = grid_feature.to(h.dtype)[None, :].expand(h.shape[0], -1)
            h = torch.cat([feat, h], dim=-1)
        return self.field(h)

    def render_rirs_batch(self, mic_poses: torch.Tensor,
                          source_poses: torch.Tensor, rots: torch.Tensor,
                          aabb: torch.Tensor,
                          grid_feature: torch.Tensor | None = None) -> torch.Tensor:
        """N full RIRs as one flat (N*T) query batch -> (N, C, F, T)."""
        N = mic_poses.shape[0]
        T = self.config.max_len
        batch = {
            "time_query": torch.arange(T, device=mic_poses.device).repeat(N),
            "mic_pose": mic_poses.repeat_interleave(T, dim=0),
            "source_pose": source_poses.repeat_interleave(T, dim=0),
            "rot": rots.repeat_interleave(T, dim=0),
        }
        out = self(batch, aabb, grid_feature)  # (N*T, C, F)
        out = out.reshape(N, T, self.config.mic_ch, self.config.n_freq_stft)
        return out.permute(0, 2, 3, 1)  # (N, C, F, T)
