"""Acoustic-field model: query encoding, forward, full-RIR sweep.

Counterpart of neraf_tpu/models/audio.py: poses normalised into the audio
AABB with out-of-box zeroing, NeRF PE of time and positions, SH-4 of the
orientation, the scene-grid descriptor concatenated first, one pose's
all-time-bins sweep (render_rir) and N RIRs' as one flat (N*T) query batch
(render_rirs_batch), the training loss, and the viewer camera's audio pose
(camera_to_audio_pose).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from neraf_tpu_torch.configs.config import AudioModelConfig
from neraf_tpu_torch.fields.acoustic import AcousticSoundField
from neraf_tpu_torch.metrics.losses import stft_loss
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


def camera_to_audio_pose(c2w_camera: np.ndarray, dataset: str = "SoundSpaces"):
    """Viewer camera pose -> (mic_pose, rot cosine) in audio coordinates.

    The reference's viewer-camera handling (NeRAF_model.py:613-646): the
    viewer frame is x-front/y-left/z-up, audio x-front/y-up/z-left; the yaw
    is the euler 'zyx' angle of the camera (SoundSpaces), rounded to whole
    degrees and given as the [cos, 0, sin] direction cosine in [0, 1]. For
    RAF the reference takes euler 'yxz' of the constant matrix
    transform_axis @ eye(4), exact gimbal lock, which scipy resolves to a
    yaw of exactly 0.0: that constant is used.
    """
    from scipy.spatial.transform import Rotation as R

    c2w = np.eye(4)
    c2w[:3, :4] = np.asarray(c2w_camera)[:3, :4]
    transform_axis = np.array([
        [1, 0, 0, 0],
        [0, 0, 1, 0],
        [0, -1, 0, 0],
        [0, 0, 0, 1],
    ])
    c2w_audio = transform_axis @ c2w
    mic_pose = c2w_audio[:3, 3]
    if dataset == "RAF":
        yaw = 0.0
    else:
        yaw = R.from_matrix(c2w[:3, :3]).as_euler("zyx", degrees=True)[0]
    yaw = np.round(yaw, decimals=0)
    rad = np.deg2rad(yaw)
    rot = (np.array([np.cos(rad), 0.0, np.sin(rad)]) + 1.0) / 2.0
    return mic_pose, rot


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

    def loss(self, predicted: torch.Tensor, gt: torch.Tensor) -> dict:
        """The training loss dict with the reference's weighting: SC at
        1e-1 and the log-magnitude term at 1, both times loss_factor."""
        cfg = self.config
        if cfg.criterion == "MSE":
            return {"audio_mse": torch.mean((predicted - gt) ** 2)
                    * cfg.loss_factor}
        parts = stft_loss(predicted, gt,
                          loss_type="mse" if "MSE" in cfg.criterion else "l1")
        return {
            "audio_sc_loss": parts["audio_sc_loss"] * 1e-1 * cfg.loss_factor,
            "audio_mag_loss": parts["audio_mag_loss"] * 1.0 * cfg.loss_factor,
        }

    def render_rir(self, mic_pose: torch.Tensor, source_pose: torch.Tensor,
                   rot: torch.Tensor, aabb: torch.Tensor,
                   grid_feature: torch.Tensor | None = None) -> torch.Tensor:
        """One pose's full sweep, all max_len time bins at once -> (C, F, T)
        (the reference's get_outputs_for_camera eval path,
        NeRAF_model.py:646-692, its T-major output permuted)."""
        T = self.config.max_len
        batch = {
            "time_query": torch.arange(T, device=mic_pose.device),
            "mic_pose": mic_pose[None, :].expand(T, 3),
            "source_pose": source_pose[None, :].expand(T, 3),
            "rot": rot[None, :].expand(T, 3),
        }
        return self(batch, aabb, grid_feature).permute(1, 2, 0)  # (C, F, T)

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
