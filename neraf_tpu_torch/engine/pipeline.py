"""Render pipelines: the serving halves of neraf_tpu/engine/pipeline.py.

RenderPipeline serves RIRs, VisionPipeline images (render_image,
evaluate_vision); the JAX package's JointPipeline owns both halves.

One RIR request (mic poses, source poses, orientations) is served as
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

import time

import numpy as np
import torch

from neraf_tpu.configs.config import ExperimentConfig
from neraf_tpu_torch.data.vision_data import generate_rays
from neraf_tpu_torch.dsp.griffin_lim import griffin_lim, random_angles
from neraf_tpu_torch.dsp.stft import log_to_magnitude
from neraf_tpu_torch.metrics.image import psnr, ssim
from neraf_tpu_torch.models.audio import AudioModel
from neraf_tpu_torch.models.grid import grid_to_volume
from neraf_tpu_torch.models.resnet3d import ResNet3D
from neraf_tpu_torch.models.vision import VisionModel

# the JAX package's explicit LPIPS skip marker (engine/pipeline.py:43-71)
LPIPS_SKIP_REASON = ("no pretrained LPIPS weights resolved (set "
                     "NERAF_LPIPS_WEIGHTS to a converted .npz)")


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


class VisionPipeline:
    """Owns the eval-mode vision model; renders images in ray chunks."""

    def __init__(self, config: ExperimentConfig, vision_model: VisionModel,
                 device="cpu"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config = config
        self.device = torch.device(device)
        self.vision_model = vision_model.to(self.device).eval()

    @torch.inference_mode()
    def render_rays(self, rays: dict, use_average_appearance: bool = True):
        """One ray batch through VisionModel.forward(train=False) (the
        counterpart of _render_rays_eval_impl)."""
        return self.vision_model(rays, use_average_appearance=use_average_appearance)

    @torch.inference_mode()
    def render_image(self, cam_arrays: dict, cam_index: int, height: int,
                     width: int, use_average_appearance: bool = True) -> dict:
        """One full image in chunks of eval_num_rays_per_chunk rays (the
        last chunk is ragged) -> rgb (H, W, 3), depth and accumulation
        (H, W), on the pipeline's device."""
        chunk = self.config.vision_model.eval_num_rays_per_chunk
        ys, xs = torch.meshgrid(torch.arange(height, device=self.device),
                                torch.arange(width, device=self.device),
                                indexing="ij")
        ys, xs = ys.reshape(-1), xs.reshape(-1)
        parts = []
        for i in range(0, ys.shape[0], chunk):
            px, py = xs[i:i + chunk], ys[i:i + chunk]
            cam = torch.full_like(px, cam_index)
            out = self.render_rays(generate_rays(cam_arrays, cam, px, py),
                                   use_average_appearance)
            parts.append([out[k] for k in ("rgb", "depth", "accumulation")])
        rgb, depth, acc = (torch.cat(p) for p in zip(*parts))
        return {"rgb": rgb.reshape(height, width, 3),
                "depth": depth.reshape(height, width),
                "accumulation": acc.reshape(height, width)}

    def evaluate_vision(self, cam_arrays: dict, images: np.ndarray,
                        use_average_appearance: bool = True) -> dict:
        """Every eval image (image i seen by camera i): PSNR, SSIM and the
        render throughput (fps, rays/s, device synchronised before each
        clock read). LPIPS is reported as skipped: no weights."""
        n, H, W = images.shape[:3]
        psnrs, ssims, times = [], [], []
        for i in range(n):
            self._sync()
            t0 = time.perf_counter()
            out = self.render_image(cam_arrays, i, H, W, use_average_appearance)
            self._sync()
            times.append(time.perf_counter() - t0)
            gt = torch.as_tensor(images[i], dtype=torch.float32,
                                 device=self.device)
            psnrs.append(float(psnr(out["rgb"], gt)))
            ssims.append(float(ssim(out["rgb"], gt)))
        dt = float(np.mean(times))
        return {
            "psnr": float(np.mean(psnrs)),
            "ssim": float(np.mean(ssims)),
            "psnr_std": float(np.std(psnrs)),
            "num_rays_per_sec": H * W / dt,
            "fps": 1.0 / dt,
            "lpips": None,
            "lpips_skipped": LPIPS_SKIP_REASON,
        }

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
