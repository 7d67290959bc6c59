"""Pipelines: the joint train step and the two serving paths of
neraf_tpu/engine/pipeline.py.

JointPipeline trains (train_step), RenderPipeline serves RIRs,
VisionPipeline images (render_image, evaluate_vision); the JAX package's
JointPipeline owns all three.

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

import os
import time

import numpy as np
import torch

from neraf_tpu_torch.configs.config import ExperimentConfig
from neraf_tpu_torch.data.loader import gather_audio_batch, sample_audio_indices
from neraf_tpu_torch.data.vision_data import generate_rays, sample_pixel_batch
from neraf_tpu_torch.dsp.griffin_lim import griffin_lim, random_angles
from neraf_tpu_torch.dsp.stft import log_to_magnitude
from neraf_tpu_torch.engine.optimizers import ScheduledAdam
from neraf_tpu_torch.metrics.image import psnr, ssim
from neraf_tpu_torch.models.audio import AudioModel
from neraf_tpu_torch.models.grid import (
    bake_cells,
    cell_centers,
    compute_fresh_cells,
    fixed_viewing_directions,
    grid_to_volume,
    init_grid,
    single_viewing_direction,
)
from neraf_tpu_torch.models.resnet3d import ResNet3D
from neraf_tpu_torch.models.vision import VisionModel

# the JAX package's explicit LPIPS skip marker (engine/pipeline.py:43-71)
LPIPS_SKIP_REASON = ("no pretrained LPIPS weights resolved (set "
                     "NERAF_LPIPS_WEIGHTS to a converted .npz)")


class RenderPipeline:
    """Owns the eval-mode ResNet, the audio model, the AABB and the grid."""

    def __init__(self, config: ExperimentConfig, resnet: ResNet3D,
                 audio_model: AudioModel, audio_aabb: torch.Tensor,
                 grid: torch.Tensor, grid_res: int, device="cuda"):
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
                 device="cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config = config
        self.device = torch.device(device)
        self.vision_model = vision_model.to(self.device).eval()

    @torch.inference_mode()
    def render_rays(self, rays: dict, use_average_appearance: bool = True):
        """One ray batch through VisionModel.forward(train=False) (the
        counterpart of _render_rays_eval_impl)."""
        return self.vision_model(rays, train=False,
                                 use_average_appearance=use_average_appearance)

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


# the random draws of one train step: pixel indices (R,), STFT-slice
# indices (B,), the three samplers' uniforms: (R, 1) each with
# use_single_jitter, else one per bin edge, (R, S + 1) for S samples
DRAW_KEYS = ("cam", "py", "px", "rec", "t", "u_init", "u_pdf0", "u_pdf1")


class JointPipeline:
    """The joint train step (counterpart of JointPipeline._train_step_impl,
    neraf_tpu/engine/pipeline.py:283-441) on one device.

    One train_step: sample R rays and B STFT slices; the vision forward in
    train mode and its losses; bake `grid_bake_cells_per_step` cells through
    the main field (a live gradient into it); the ResNet in train mode over
    the grid with the fresh cells spliced in; the acoustic field and its
    STFT losses, multiplied by 0 until step > start_step_audio; one
    backward; the four Adam groups, the vision field stepped by both
    `fields` and `audio_fields` with the same gradient; the gated BatchNorm
    statistics; the grid, cursor and step advanced.

    Parameters stay float32; with trainer.mixed_precision the vision fields
    compute in bf16 through their dtype (as flax's Dense does) and the
    ResNet and the acoustic field under torch.autocast. float32 runs are
    full float32: TF32 is off for matmuls and cuDNN convolutions. The
    state (weights, Adam moments, grid, cursor, step, generator) lives in
    the pipeline and is updated in place.

    The ResNet stem's weight gradient: with NERAF_STEM_WGRAD_PALLAS=1 in
    the environment when the pipeline is built (the reference's own gate,
    neraf_tpu/engine/pipeline.py:88-100, read once here), the stem runs
    through ops/stem_conv.py and its weight gradient is the CUDA kernel
    csrc/stem_wgrad.cu on a card (the plain version on the CPU), once a
    step; otherwise, the default as in the reference, cuDNN's.
    """

    def __init__(self, config: ExperimentConfig, vision_model: VisionModel,
                 audio_model: AudioModel, resnet: ResNet3D, audio_aabb,
                 vision_aabb, grid_res: int, device="cuda", seed: int = 0):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config = config
        self.device = torch.device(device)
        self.mixed = bool(config.trainer.mixed_precision)
        self.vision_model = vision_model.to(self.device).train()
        self.audio_model = audio_model.to(self.device).train()
        self.resnet = resnet.to(self.device).train()
        self.resnet.stem_wgrad_kernel = (
            os.environ.get("NERAF_STEM_WGRAD_PALLAS", "0") == "1")
        as_f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                           device=self.device)
        self.audio_aabb, self.vision_aabb = as_f32(audio_aabb), as_f32(vision_aabb)
        self.grid_res = grid_res
        # an empty grid at cursor and step 0; bridge.load_joint_state
        # restores a JAX state's
        self.grid = as_f32(init_grid(grid_res))
        self.cursor, self.step = 0, 0
        self.cells = as_f32(cell_centers(grid_res))
        bake = config.trainer.grid_bake_cells_per_step
        # the bake splices one contiguous batch: it must tile the grid
        assert bake > 0 and self.cells.shape[0] % bake == 0, (
            f"grid_bake_cells_per_step={bake} must divide grid_res^3="
            f"{self.cells.shape[0]}: the bake would double-write cells")
        self.view_dirs = (
            fixed_viewing_directions(self.device)
            if config.audio_model.use_multiple_viewing_directions
            else single_viewing_direction(self.device))
        ocfg = config.optimizers
        field = list(vision_model.field.parameters())
        self.optimizers = {
            "proposal_networks": ScheduledAdam(
                vision_model.proposal_networks.parameters(),
                ocfg.proposal_networks),
            "fields": ScheduledAdam(field, ocfg.fields),
            "camera_opt": ScheduledAdam([vision_model.camera_opt],
                                        ocfg.camera_opt),
            # the reference appends the vision field to the audio group
            "audio_fields": ScheduledAdam(
                [*audio_model.parameters(), *resnet.parameters(), *field],
                ocfg.audio_fields),
        }
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.profile = None  # a list: train_step appends (stage, CUDA event)

    def _mark(self, stage: str) -> None:
        if self.profile is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.profile.append((stage, ev))

    def draw(self, n_cams: int, height: int, width: int, n_rec: int) -> dict:
        """One step's random draws (DRAW_KEYS) from the pipeline's
        generator, on its device."""
        R = self.config.vision_data.train_rays_per_batch
        gen, dev = self.generator, self.device
        cam, py, px = sample_pixel_batch(n_cams, height, width, R, gen, dev)
        rec, t = sample_audio_indices(n_rec, self.audio_model.config.max_len,
                                      self.config.audio_data.batch_size, gen,
                                      dev)
        vcfg = self.config.vision_model
        widths = ((1, 1, 1) if vcfg.use_single_jitter else
                  (*(s + 1 for s in vcfg.num_proposal_samples),
                   vcfg.num_nerf_samples + 1))
        u = [torch.rand((R, k), generator=gen, device=dev) for k in widths]
        return dict(zip(DRAW_KEYS, (cam, py, px, rec, t, *u)))

    def anneal(self) -> float:
        """Proposal-weight annealing, bias(step / 1000, 10), in float32."""
        frac = np.clip(np.float32(self.step) / np.float32(1000.0), 0.0, 1.0)
        slope = np.float32(10.0)
        return float(slope * frac / ((slope - 1.0) * frac + 1.0))

    def train_step(self, cam_arrays: dict, audio_arrays: dict,
                   image_arrays: dict, draws: dict | None = None) -> dict:
        """One joint step -> metrics (floats): the five losses, total_loss,
        and the learning rates the fields and audio_fields groups used.
        `draws` holds DRAW_KEYS (numpy or tensors), else they are drawn."""
        tcfg = self.config.trainer
        images = image_arrays["images"]
        if draws is None:
            draws = self.draw(images.shape[0], images.shape[1], images.shape[2],
                              audio_arrays["log_stft"].shape[0])
        d = {k: torch.as_tensor(draws[k], device=self.device) for k in DRAW_KEYS}
        self._mark("start")
        rays = generate_rays(cam_arrays, d["cam"], d["px"], d["py"])
        gt_rgb = images[d["cam"], d["py"], d["px"]]
        batch = gather_audio_batch(audio_arrays, d["rec"], d["t"])
        active = self.step > tcfg.start_step_audio
        self.resnet.set_update_stats(active)

        vout = self.vision_model(
            rays, train=True, anneal=self.anneal(),
            jitter=[d[k].to(torch.float32).reshape(d[k].shape[0], -1)
                    for k in ("u_init", "u_pdf0", "u_pdf1")])
        losses = self.vision_model.loss(vout, gt_rgb)
        self._mark("vision_forward")
        fresh = compute_fresh_cells(
            self.vision_model.query_density_rgb, self.cursor, self.cells,
            self.vision_aabb, tcfg.grid_bake_cells_per_step, self.view_dirs)
        grid, cursor = bake_cells(self.grid, self.cursor, fresh)
        self._mark("bake")
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.mixed):
            feat = self.resnet(grid_to_volume(grid, self.grid_res))[0]
            self._mark("resnet_forward")
            aout = self.audio_model(batch, self.audio_aabb,
                                    grid_feature=feat.float())
        # the masked losses still backpropagate (zeros): every group steps
        mask = 1.0 if active else 0.0
        for k, v in self.audio_model.loss(aout.float(), batch["data"]).items():
            losses[k] = v * mask
        total = sum(losses.values())
        self._mark("audio_forward")

        for opt in self.optimizers.values():
            opt.opt.zero_grad(set_to_none=True)
        total.backward()
        self._mark("backward")
        lrs = {"lr_fields": self.optimizers["fields"].lr,
               "lr_audio_fields": self.optimizers["audio_fields"].lr}
        for opt in self.optimizers.values():
            opt.step()
        self._mark("optimizers")

        self.grid, self.cursor = grid.detach(), cursor
        self.step += 1
        values = torch.stack([v.detach().float()
                              for v in (*losses.values(), total)]).tolist()
        metrics = dict(zip((*losses, "total_loss"), values))
        metrics.update(lrs)
        return metrics
