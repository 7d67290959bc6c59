"""RIR render pipeline: the serving half of neraf_tpu/engine/pipeline.py.

One request (mic poses, source poses, orientations) is served as
  1. the scene grid through ResNet3D in eval mode -> one descriptor,
  2. the acoustic field over all T STFT frames of every RIR -> log-mags,
  3. log_to_magnitude,
  4. Griffin-Lim -> waveform (the CUDA kernel on a card).

Compute runs in bfloat16 when config.trainer.mixed_precision is set, as in
the JAX package; log_to_magnitude then runs on the field's bf16 output and
Griffin-Lim casts to f32. float32 runs are full float32: TF32 is switched
off for both matmuls and cuDNN convolutions.
"""

from __future__ import annotations

import torch

from neraf_tpu.configs.config import ExperimentConfig
from neraf_tpu_torch.dsp.griffin_lim import griffin_lim, random_angles
from neraf_tpu_torch.dsp.stft import log_to_magnitude
from neraf_tpu_torch.models.audio import AudioModel
from neraf_tpu_torch.models.grid import grid_to_volume
from neraf_tpu_torch.models.resnet3d import ResNet3D


class RenderPipeline:
    """Owns the eval-mode ResNet, the audio model, the AABB and the grid."""

    def __init__(self, config: ExperimentConfig, resnet: ResNet3D,
                 audio_model: AudioModel, audio_aabb: torch.Tensor,
                 grid: torch.Tensor, grid_res: int, device="cpu"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config = config
        self.device = torch.device(device)
        self.dtype = (torch.bfloat16 if config.trainer.mixed_precision
                      else torch.float32)
        self.resnet = resnet.to(self.device, self.dtype).eval()
        self.audio_model = audio_model.to(self.device, self.dtype).eval()
        self.audio_aabb = torch.as_tensor(audio_aabb, dtype=torch.float32,
                                          device=self.device)
        self.grid = torch.as_tensor(grid, dtype=torch.float32, device=self.device)
        self.grid_res = grid_res

    def _poses(self, *arrays):
        return [torch.as_tensor(a, dtype=torch.float32, device=self.device)
                for a in arrays]

    @torch.inference_mode()
    def grid_feature(self) -> torch.Tensor:
        """The (feature_dim,) f32 scene descriptor (eval-mode BN)."""
        return self.resnet(grid_to_volume(self.grid, self.grid_res))[0]

    @torch.inference_mode()
    def render_rirs(self, mic, src, rot) -> torch.Tensor:
        """(N, 3) poses and orientations -> (N, C, F, T) log-magnitudes."""
        mic, src, rot = self._poses(mic, src, rot)
        return self.audio_model.render_rirs_batch(
            mic, src, rot, self.audio_aabb, grid_feature=self.grid_feature())

    def _griffin_lim(self, mag, angles):
        cfg = self.audio_model.config
        return griffin_lim(mag, n_fft=cfg.n_fft, hop_length=cfg.hop_len,
                           win_length=cfg.win_len, init_angles=angles)

    @torch.inference_mode()
    def render_rir_chunk(self, mic, src, rot, gt_log, generator=None):
        """(log_pred, mag_pred, mag_gt, wav_pred, wav_gt_istft); both
        Griffin-Lim runs start from the same angles, as the JAX eval does."""
        log_pred = self.render_rirs(mic, src, rot)
        mag_pred = log_to_magnitude(log_pred)
        mag_gt = log_to_magnitude(torch.as_tensor(gt_log, device=self.device))
        angles = random_angles(mag_pred.shape, generator, self.device)
        return (log_pred, mag_pred, mag_gt, self._griffin_lim(mag_pred, angles),
                self._griffin_lim(mag_gt, angles))

    @torch.inference_mode()
    def render_waveforms(self, mic, src, rot, generator=None) -> torch.Tensor:
        """The served request: poses -> (N, C, length) f32 waveforms."""
        mag = log_to_magnitude(self.render_rirs(mic, src, rot))
        angles = random_angles(mag.shape, generator, self.device)
        return self._griffin_lim(mag, angles)
