"""Pipelines: the joint train step and the two serving paths of
neraf_tpu/engine/pipeline.py.

JointPipeline trains (train_step) and evaluates itself (the eval paths of
neraf_tpu/engine/pipeline.py:446-873), RenderPipeline serves RIRs,
VisionPipeline images (render_image, evaluate_vision); the JAX package's
JointPipeline owns all three.

One RIR request (mic poses, source poses, orientations) is served as
  1. the scene grid through ResNet3D in eval mode -> one descriptor (its
     s2d stem folds the flat grid once a request),
  2. the acoustic field over all T STFT frames of every RIR -> log-mags,
  3. log_to_magnitude,
  4. Griffin-Lim -> waveform (the CUDA kernel on a card).

Compute runs in bfloat16 when config.trainer.mixed_precision is set, as in
the JAX package; log_to_magnitude then runs on the field's bf16 output and
Griffin-Lim casts to f32. float32 runs are full float32: TF32 is switched
off for both matmuls and cuDNN convolutions.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import numpy as np
import torch

from neraf_tpu_torch.configs.config import ExperimentConfig
from neraf_tpu_torch.data.loader import (
    num_recordings,
    resolve_audio_batch,
    sample_audio_indices,
)
from neraf_tpu_torch.data.vision_data import generate_rays, sample_pixel_batch
from neraf_tpu_torch.dsp.griffin_lim import griffin_lim, random_angles
from neraf_tpu_torch.dsp.stft import log_to_magnitude
from neraf_tpu_torch.engine.optimizers import ScheduledAdam
from neraf_tpu_torch.metrics import lpips_impl
from neraf_tpu_torch.metrics.evaluators import make_evaluator
from neraf_tpu_torch.metrics.image import psnr, ssim
from neraf_tpu_torch.metrics.room_acoustics import (
    batched_clarity,
    batched_edt,
    batched_rt60,
    batched_rt60_advance,
)
from neraf_tpu_torch.models.audio import AudioModel
from neraf_tpu_torch.models.grid import (
    bake_cells,
    bake_cells_folded,
    cell_centers,
    compute_fresh_cells,
    fixed_viewing_directions,
    fold_grid,
    folded_bake_supported,
    grid_to_volume,
    init_grid,
    single_viewing_direction,
)
from neraf_tpu_torch.models.resnet3d import ResNet3D
from neraf_tpu_torch.models.vision import VisionModel
from neraf_tpu_torch.parallel.sharding import (
    all_gather_batch,
    average_gradients,
    block_range,
    shard_batch,
)
from neraf_tpu_torch.viz.panels import grid_top_view, stft_comparison_panel

# the JAX package's explicit LPIPS skip marker (engine/pipeline.py:43-71)
LPIPS_SKIP_REASON = ("no pretrained LPIPS weights resolved (set "
                     "NERAF_LPIPS_WEIGHTS to a converted .npz)")
_lpips_warned = False


def _maybe_lpips(pred, gt) -> float | None:
    """LPIPS of one view with the converted weights that resolve
    (metrics/lpips_impl.py), on pred's device; None when none resolve
    (warned once, on stderr) or when the image is under the backbone's
    minimum size: the caller then reports lpips null with
    LPIPS_SKIP_REASON, as the JAX package's _maybe_lpips."""
    global _lpips_warned
    path = lpips_impl.resolve_default_weights()
    if path is None:
        if not _lpips_warned:
            print(f"WARNING: lpips skipped — {LPIPS_SKIP_REASON}",
                  file=sys.stderr, flush=True)
            _lpips_warned = True
        return None
    pred = torch.as_tensor(pred)
    params, net = lpips_impl.load_device_params(str(path), str(pred.device))
    try:
        return float(lpips_impl.lpips_distance(params, pred, gt, net=net))
    except ValueError:  # image smaller than the backbone's minimum size
        return None


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (before a host clock read)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def gl_waveforms(audio_config, mag: torch.Tensor,
                 angles: torch.Tensor) -> torch.Tensor:
    """Griffin-Lim at the audio model's STFT geometry from `angles`."""
    cfg = audio_config
    return griffin_lim(mag, n_fft=cfg.n_fft, hop_length=cfg.hop_len,
                       win_length=cfg.win_len, init_angles=angles)


def _as_f32(device, *arrays) -> list:
    return [torch.as_tensor(a, dtype=torch.float32, device=device)
            for a in arrays]


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

    @torch.inference_mode()
    def grid_feature(self) -> torch.Tensor:
        """The (feature_dim,) f32 scene descriptor (eval-mode BN)."""
        return self.resnet(grid_to_volume(self.grid, self.grid_res))[0]

    @torch.inference_mode()
    def render_rirs(self, mic, src, rot) -> torch.Tensor:
        """(N, 3) poses and orientations -> (N, C, F, T) log-magnitudes."""
        mic, src, rot = _as_f32(self.device, mic, src, rot)
        return self.audio_model.render_rirs_batch(
            mic, src, rot, self.audio_aabb, grid_feature=self.grid_feature())

    @torch.inference_mode()
    def render_rir_chunk(self, mic, src, rot, gt_log, generator=None):
        """(log_pred, mag_pred, mag_gt, wav_pred, wav_gt_istft); both
        Griffin-Lim runs start from the same angles, as the JAX eval does."""
        log_pred = self.render_rirs(mic, src, rot)
        mag_pred = log_to_magnitude(log_pred)
        mag_gt = log_to_magnitude(torch.as_tensor(gt_log, device=self.device))
        angles = random_angles(mag_pred.shape, generator, self.device)
        cfg = self.audio_model.config
        return (log_pred, mag_pred, mag_gt, gl_waveforms(cfg, mag_pred, angles),
                gl_waveforms(cfg, mag_gt, angles))

    @torch.inference_mode()
    def render_waveforms(self, mic, src, rot, generator=None) -> torch.Tensor:
        """The served request: poses -> (N, C, length) f32 waveforms."""
        mag = log_to_magnitude(self.render_rirs(mic, src, rot))
        angles = random_angles(mag.shape, generator, self.device)
        return gl_waveforms(self.audio_model.config, mag, angles)


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
        """Every eval image (image i seen by camera i): PSNR, SSIM, the
        render throughput (fps, rays/s, device synchronised before each
        clock read) and LPIPS's mean and std, or lpips null and the skip
        reason when no view has an LPIPS value (_maybe_lpips)."""
        n, H, W = images.shape[:3]
        psnrs, ssims, lpipss, times = [], [], [], []
        for i in range(n):
            synchronize(self.device)
            t0 = time.perf_counter()
            out = self.render_image(cam_arrays, i, H, W, use_average_appearance)
            synchronize(self.device)
            times.append(time.perf_counter() - t0)
            gt = torch.as_tensor(images[i], dtype=torch.float32,
                                 device=self.device)
            psnrs.append(float(psnr(out["rgb"], gt)))
            ssims.append(float(ssim(out["rgb"], gt)))
            lp = _maybe_lpips(out["rgb"], gt)
            if lp is not None:
                lpipss.append(lp)
        dt = float(np.mean(times))
        result = {
            "psnr": float(np.mean(psnrs)),
            "ssim": float(np.mean(ssims)),
            "psnr_std": float(np.std(psnrs)),
            "num_rays_per_sec": H * W / dt,
            "fps": 1.0 / dt,
        }
        if lpipss:
            result["lpips"] = float(np.mean(lpipss))
            result["lpips_std"] = float(np.std(lpipss))
        else:
            result["lpips"] = None
            result["lpips_skipped"] = LPIPS_SKIP_REASON
        return result


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

    The pre-folded grid (neraf_tpu/engine/pipeline.py:170-176, 345-371):
    when one cursor batch is one slab of the space-to-depth folded volume
    (models/grid.py::folded_bake_supported; R 128 at 4096 cells does),
    `grid_folded` holds the folded copy of the grid in the ResNet's compute
    dtype (bf16 with mixed precision, else f32). A step then bakes the
    detached fresh cells into the flat grid (bookkeeping: checkpoints and
    the eval paths read it), splices the live slab into `grid_folded` in
    place, and runs the ResNet on the folded state through
    ops/baked_stem.py (the slab's input gradient alone). Otherwise
    `grid_folded` is None and the step splices the live cells into the
    flat grid, whose volume the s2d stem folds, as the reference's other
    branch does. `grid_folded` is derived state: assigning `grid` (a
    checkpoint's restore, bridge.load_joint_state) refolds it, and no
    checkpoint holds it.

    Under a data mesh (`mesh`, parallel/sharding.py: one process a rank,
    one device a rank) a step computes what the JAX package's mesh step
    computes, the step on the global batch: every rank draws the global
    DRAW_KEYS from its generator (the same on every rank) and takes its
    block of the rays and STFT slices (parallel/sharding.py::partition:
    blocks of ceil(n / N), the last shorter, so no count need divide by
    N); it bakes its block of the fresh cells and gathers the others'
    (all_gather_batch), so that the grid, the folded state and the live
    slab are the same on every rank and the bake's gradient goes back to
    the rank that computed each cell; the ResNet runs split by depth over
    the ranks where the JAX package's reshard rule splits it
    (parallel/depth_split.py: halo exchanges, BatchNorm statistics and the
    final pool over the global volume, the same statistics and feature on
    every rank); the losses are the global batch's (models/vision.py,
    models/audio.py); after the backward the gradients are averaged over
    ranks before the four Adam groups, so the parameters stay bitwise
    equal across ranks. The kernels run on each rank's blocks as on one
    device. evaluate_audio_device fans each chunk's RIRs out over the
    ranks; the eval paths that every rank calls (eval_loss_dict and both
    sweeps) compute the grid feature split, as the JAX package does under
    its mesh; render_rirs, which rank 0 alone calls for the viewer, runs
    the ResNet whole.

    The stem's weight gradient on the folded path: with
    NERAF_STEM_WGRAD_PALLAS=1 in the environment when the pipeline is
    built (the reference's own gate, neraf_tpu/engine/pipeline.py:88-100,
    read once here into `stem_wgrad_kernel`), the CUDA kernel
    csrc/stem_wgrad.cu on a card (the plain version on the CPU), once a
    step; otherwise, the default as in the reference, cuDNN's.
    """

    def __init__(self, config: ExperimentConfig, vision_model: VisionModel,
                 audio_model: AudioModel, resnet: ResNet3D, audio_aabb,
                 vision_aabb, grid_res: int, device="cuda", seed: int = 0,
                 mesh=None):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config = config
        self.device = torch.device(device)
        self.mesh = mesh
        self.rank, self.world = ((0, 1) if mesh is None
                                 else (mesh.rank, mesh.world_size))
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"a pipeline on {self.device} for a rank on "
                             f"{mesh.device}")
        self.mixed = bool(config.trainer.mixed_precision)
        self.vision_model = vision_model.to(self.device).train()
        self.audio_model = audio_model.to(self.device).train()
        self.resnet = resnet.to(self.device).train()
        self.stem_wgrad_kernel = (
            os.environ.get("NERAF_STEM_WGRAD_PALLAS", "0") == "1")
        as_f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                           device=self.device)
        self.audio_aabb, self.vision_aabb = as_f32(audio_aabb), as_f32(vision_aabb)
        self.grid_res = grid_res
        self.cells = as_f32(cell_centers(grid_res))
        bake = config.trainer.grid_bake_cells_per_step
        # the bake splices one contiguous batch: it must tile the grid
        assert bake > 0 and self.cells.shape[0] % bake == 0, (
            f"grid_bake_cells_per_step={bake} must divide grid_res^3="
            f"{self.cells.shape[0]}: the bake would double-write cells")
        self.folded_bake = folded_bake_supported(grid_res, bake)
        self.folded_dtype = torch.bfloat16 if self.mixed else torch.float32
        # an empty grid at cursor and step 0; bridge.load_joint_state
        # restores a JAX state's
        self.grid = as_f32(init_grid(grid_res))
        self.cursor, self.step = 0, 0
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

    @property
    def grid(self) -> torch.Tensor:
        """The flat (R^3, 7) f32 grid."""
        return self._grid

    @grid.setter
    def grid(self, grid: torch.Tensor) -> None:
        """Set the flat grid and refold grid_folded from it."""
        self._grid = grid
        self.grid_folded = (fold_grid(grid, self.grid_res, self.folded_dtype)
                            if self.folded_bake else None)

    @property
    def models(self) -> dict:
        """The modules a checkpoint holds (engine/checkpoints.py)."""
        return {"vision_model": self.vision_model,
                "audio_model": self.audio_model, "resnet": self.resnet}

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
        `audio_arrays` is the device-resident split or a streamed batch
        (data/loader.py::resolve_audio_batch); a streamed batch brings its
        own (rec, t), and the step still draws, so that its other draws
        are the resident step's. `draws` holds DRAW_KEYS (numpy or
        tensors), else they are drawn."""
        tcfg = self.config.trainer
        images = image_arrays["images"]
        if draws is None:
            draws = self.draw(images.shape[0], images.shape[1], images.shape[2],
                              num_recordings(audio_arrays))
        # under a mesh, this rank's block of the global draws
        d = shard_batch({k: torch.as_tensor(draws[k], device=self.device)
                         for k in DRAW_KEYS}, self.mesh)
        self._mark("start")
        rays = generate_rays(cam_arrays, d["cam"], d["px"], d["py"])
        gt_rgb = images[d["cam"], d["py"], d["px"]]
        batch = resolve_audio_batch(audio_arrays, d["rec"], d["t"])
        if batch["data"].shape[0] != d["rec"].shape[0]:
            raise ValueError(
                f"a streamed batch of {batch['data'].shape[0]} STFT slices "
                f"for a step of {d['rec'].shape[0]} (a rank's block comes "
                f"from StreamingAudioSampler(mesh=...))")
        active = self.step > tcfg.start_step_audio
        self.resnet.set_update_stats(active)

        vout = self.vision_model(
            rays, train=True, anneal=self.anneal(),
            jitter=[d[k].to(torch.float32).reshape(d[k].shape[0], -1)
                    for k in ("u_init", "u_pdf0", "u_pdf1")])
        losses = self.vision_model.loss(vout, gt_rgb, self.mesh)
        self._mark("vision_forward")
        # this rank's block of the cursor batch, then every rank's
        n_bake = tcfg.grid_bake_cells_per_step
        lo, hi = block_range(n_bake, self.mesh)
        fresh = all_gather_batch(compute_fresh_cells(
            self.vision_model.query_density_rgb, self.cursor + lo, self.cells,
            self.vision_aabb, hi - lo, self.view_dirs), self.mesh, n=n_bake)
        if self.grid_folded is not None:
            # the flat grid is bookkeeping; the live slab is spliced into
            # the folded state, which is not written again before backward
            grid, cursor = bake_cells(self.grid, self.cursor, fresh.detach())
            slab = bake_cells_folded(self.grid_folded, self.cursor, fresh,
                                     self.cells, self.grid_res)
            vol, stem_args = self.grid_folded, {
                "bake_slab": (*slab, self.stem_wgrad_kernel)}
        else:
            grid, cursor = bake_cells(self.grid, self.cursor, fresh)
            vol, stem_args = grid_to_volume(grid, self.grid_res), {}
        self._mark("bake")
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.mixed):
            feat = self.resnet(vol, mesh=self.mesh, **stem_args)[0]
            self._mark("resnet_forward")
            aout = self.audio_model(batch, self.audio_aabb,
                                    grid_feature=feat.float())
        # the masked losses still backpropagate (zeros): every group steps
        mask = 1.0 if active else 0.0
        for k, v in self.audio_model.loss(aout.float(), batch["data"],
                                          self.mesh).items():
            losses[k] = v * mask
        total = sum(losses.values())
        self._mark("audio_forward")

        for opt in self.optimizers.values():
            opt.opt.zero_grad(set_to_none=True)
        total.backward()
        self._mark("backward")
        if self.mesh is not None:
            average_gradients([p for opt in self.optimizers.values()
                               for p in opt.params], self.mesh)
            self._mark("all_reduce")
        lrs = {"lr_fields": self.optimizers["fields"].lr,
               "lr_audio_fields": self.optimizers["audio_fields"].lr}
        for opt in self.optimizers.values():
            opt.step()
        self._mark("optimizers")

        # grid_folded already holds the fresh cells: no refold
        self._grid, self.cursor = grid.detach(), cursor
        self.step += 1
        values = torch.stack([v.detach().float()
                              for v in (*losses.values(), total)]).tolist()
        metrics = dict(zip((*losses, "total_loss"), values))
        metrics.update(lrs)
        return metrics

    # ------------------------------------------------------------------ eval
    # The eval paths of neraf_tpu/engine/pipeline.py:446-873. Each runs the
    # three models in eval mode (BatchNorm on its running statistics, none
    # updated) without autograd, and leaves the train state as it found it:
    # weights, statistics, grid, cursor, step, Adam state and the train
    # generator (eval draws come from a generator of their own, seeded 0
    # when none is given, as the reference's default key is PRNGKey(0)).

    @contextlib.contextmanager
    def _eval_mode(self):
        models = (self.vision_model, self.audio_model, self.resnet)
        modes = [m.training for m in models]
        for m in models:
            m.eval()
        try:
            with torch.no_grad():
                yield
        finally:
            for m, mode in zip(models, modes):
                m.train(mode)

    def _autocast(self):
        return torch.autocast(self.device.type, dtype=torch.bfloat16,
                              enabled=self.mixed)

    def _eval_generator(self, generator):
        return (torch.Generator(device=self.device).manual_seed(0)
                if generator is None else generator)

    def _grid_feature_eval(self, split: bool = True) -> torch.Tensor:
        """The scene descriptor, eval-mode BatchNorm, under the step's
        autocast (call inside _eval_mode); the s2d stem folds the flat grid,
        as the reference's eval paths do. Under a data mesh, with `split`
        (every rank calling), the ResNet runs split by depth over the
        ranks; without it, whole on the calling rank alone."""
        with self._autocast():
            return self.resnet(grid_to_volume(self.grid, self.grid_res),
                               mesh=self.mesh if split else None)[0].float()

    def _render_log(self, feat, mic, src, rot) -> torch.Tensor:
        with self._autocast():
            return self.audio_model.render_rirs_batch(
                mic, src, rot, self.audio_aabb, grid_feature=feat)

    def render_rirs(self, mic, src, rot) -> torch.Tensor:
        """(N, 3) poses and orientations -> (N, C, F, T) log-magnitudes
        (the counterpart of _render_rirs_impl). It takes no collective
        under a data mesh (a viewer request reaches rank 0 alone): the
        ResNet runs whole."""
        with self._eval_mode():
            return self._render_log(self._grid_feature_eval(split=False),
                                    *_as_f32(self.device, mic, src, rot))

    def eval_draws(self, n_cams: int, height: int, width: int,
                   n_rec: int) -> dict:
        """One eval batch's draws: cam, py, px (eval_rays_per_batch) and
        rec, t (audio_data.batch_size), from a generator seeded 0: the same
        batch every call, as the reference's default key."""
        gen, dev = self._eval_generator(None), self.device
        cam, py, px = sample_pixel_batch(
            n_cams, height, width, self.config.vision_data.eval_rays_per_batch,
            gen, dev)
        rec, t = sample_audio_indices(n_rec, self.audio_model.config.max_len,
                                      self.config.audio_data.batch_size, gen,
                                      dev)
        return {"cam": cam, "py": py, "px": px, "rec": rec, "t": t}

    def eval_loss_dict(self, cam_arrays: dict, audio_arrays: dict,
                       image_arrays: dict, draws: dict | None = None) -> dict:
        """One eval batch of rays and STFT slices -> the train step's
        losses (the audio ones unmasked) and the quick audio metrics.
        `audio_arrays` as in train_step (a streamed batch's own (rec, t)
        are used). `draws` holds cam, py, px, rec, t (numpy or tensors),
        else eval_draws() makes them."""
        images = image_arrays["images"]
        if self.mesh is not None and "data" in audio_arrays:
            # a rank's block of a streamed batch: the eval takes the whole
            audio_arrays = {**audio_arrays, **{
                k: all_gather_batch(audio_arrays[k], self.mesh,
                                    n=self.config.audio_data.batch_size)
                for k in ("data", "audio_idx", "time_query")}}
        if draws is None:
            draws = self.eval_draws(images.shape[0], images.shape[1],
                                    images.shape[2],
                                    num_recordings(audio_arrays))
        d = {k: torch.as_tensor(draws[k], device=self.device)
             for k in ("cam", "py", "px", "rec", "t")}
        with self._eval_mode():
            rays = generate_rays(cam_arrays, d["cam"], d["px"], d["py"])
            vout = self.vision_model(rays, train=False)
            losses = self.vision_model.loss(vout, images[d["cam"], d["py"], d["px"]])
            batch = resolve_audio_batch(audio_arrays, d["rec"], d["t"])
            feat = self._grid_feature_eval()
            with self._autocast():
                aout = self.audio_model(batch, self.audio_aabb,
                                        grid_feature=feat)
            losses.update(self.audio_model.loss(aout.float(), batch["data"]))
            mag_pred = log_to_magnitude(aout).float()
            mag_gt = log_to_magnitude(batch["data"])
        values = torch.stack([v.float() for v in losses.values()]).tolist()
        out = dict(zip(losses, values))
        cfg = self.audio_model.config
        out.update(make_evaluator(cfg.dataset, cfg.fs).get_stft_metrics(
            mag_pred.cpu().numpy(), mag_gt.cpu().numpy()))
        return out

    def _vision_pipeline(self) -> VisionPipeline:
        """VisionPipeline's chunk loop and metrics on the joint model (its
        constructor puts the model in eval mode: call inside _eval_mode,
        which restores the mode)."""
        return VisionPipeline(self.config, self.vision_model, self.device)

    def render_image(self, cam_arrays: dict, cam_index: int, height: int,
                     width: int, use_average_appearance: bool = True) -> dict:
        """One full image (VisionPipeline.render_image) -> rgb (H, W, 3),
        depth and accumulation (H, W) on the pipeline's device."""
        with self._eval_mode():
            return self._vision_pipeline().render_image(
                cam_arrays, cam_index, height, width, use_average_appearance)

    def evaluate_vision(self, cam_arrays: dict, images: np.ndarray,
                        use_average_appearance: bool = True) -> dict:
        """Every eval image (VisionPipeline.evaluate_vision): PSNR, SSIM,
        throughput, LPIPS (or its skip). use_average_appearance=False
        renders with each camera's own trained embedding, right where the
        eval views are training views."""
        with self._eval_mode():
            return self._vision_pipeline().evaluate_vision(
                cam_arrays, images, use_average_appearance)

    def eval_image(self, cam_arrays: dict, cam_index: int,
                   gt_image: np.ndarray,
                   eval_audio_item: dict | None = None) -> tuple[dict, dict]:
        """One eval view (and one RIR) -> metrics and images: PSNR, SSIM,
        LPIPS or its skip marker; the rendered rgb, depth and accumulation; for
        an audio item (mic_pose, source_pose, rot, data (C, F, T)) a
        comparison panel per channel, the grid's top views and audio_mag."""
        H, W = gt_image.shape[:2]
        out = self.render_image(cam_arrays, cam_index, H, W)
        gt = torch.as_tensor(np.asarray(gt_image, np.float32), device=self.device)
        metrics = {"psnr": float(psnr(out["rgb"], gt)),
                   "ssim": float(ssim(out["rgb"], gt)), "num_rays": H * W,
                   "lpips": _maybe_lpips(out["rgb"], gt)}
        if metrics["lpips"] is None:
            metrics["lpips_skipped"] = LPIPS_SKIP_REASON
        images = {"img": out["rgb"].cpu().numpy(),
                  "depth": out["depth"].cpu().numpy(),
                  "accumulation": out["accumulation"].cpu().numpy()}
        if eval_audio_item is not None:
            item = eval_audio_item
            log_pred = self.render_rirs(
                *(np.asarray(item[k], np.float32)[None]
                  for k in ("mic_pose", "source_pose", "rot")))[0].float().cpu()
            gt_log = torch.as_tensor(np.asarray(item["data"], np.float32))
            for ch in range(log_pred.shape[0]):
                images[f"comparison_ch_{ch}"] = stft_comparison_panel(
                    log_pred[ch].numpy(), gt_log[ch].numpy())
            tv = grid_top_view(self.grid.cpu().numpy(), self.grid_res)
            images["grid"] = tv["color"]
            images["grid_density"] = tv["density"]
            metrics["audio_mag"] = float(np.mean(
                (log_to_magnitude(log_pred).numpy()
                 - log_to_magnitude(gt_log).numpy()) ** 2) * 2)
        return metrics, images

    def query_grid_full(self, batch_size: int = 4096) -> torch.Tensor:
        """Every cell of the grid baked from the radiance field, the bake
        cursor run over all of them without gradients -> a new (N_cells, 7)
        grid; the pipeline's own grid is not touched."""
        n = self.cells.shape[0]
        if n % batch_size:
            raise ValueError(f"batch_size={batch_size} must divide the "
                             f"{n} cells")
        grid = self.grid.clone()
        with self._eval_mode():
            for cursor in range(0, n, batch_size):
                grid[cursor:cursor + batch_size, :4] = compute_fresh_cells(
                    self.vision_model.query_density_rgb, cursor, self.cells,
                    self.vision_aabb, batch_size, self.view_dirs)
        return grid

    def _sweep_angles(self, shape, generator, init_angles) -> torch.Tensor:
        """The Griffin-Lim start of every chunk of a sweep, at the chunk's
        shape: every chunk, and the prediction's and GT's runs, start from
        these (a ragged last chunk from its first rows)."""
        if init_angles is not None:
            return torch.as_tensor(init_angles, device=self.device).to(
                torch.complex64)
        return random_angles(shape, self._eval_generator(generator),
                             self.device)

    def render_rir_chunk(self, mic, src, rot, gt_log, angles,
                         feat: torch.Tensor | None = None):
        """One chunk -> (log_pred, mag_pred, mag_gt, wav_pred, wav_gt_istft):
        both Griffin-Lim runs from `angles` (M, C, F, T); `feat` is the grid
        feature, computed here (whole, on the calling rank) when not
        given."""
        with self._eval_mode():
            if feat is None:
                feat = self._grid_feature_eval(split=False)
            mic, src, rot, gt_log = _as_f32(self.device, mic, src, rot, gt_log)
            log_pred = self._render_log(feat, mic, src, rot)
            mag_pred = log_to_magnitude(log_pred)
            mag_gt = log_to_magnitude(gt_log)
            return (log_pred, mag_pred, mag_gt,
                    gl_waveforms(self.audio_model.config, mag_pred, angles),
                    gl_waveforms(self.audio_model.config, mag_gt, angles))

    def evaluate_audio(self, dataset, chunk: int = 512,
                       generator: torch.Generator | None = None,
                       init_angles=None) -> dict:
        """Every eval RIR: rendered and Griffin-Limed (prediction and GT)
        in chunks on the device, the metrics on the host per RIR through
        the dataset's evaluator (the metric of record) -> the mean and
        `_std` of each, and fps_audio / num_rays_per_sec_audio over the
        render time only (the device synchronised before each clock read;
        the grid feature, computed once a sweep, counted in it). Under a
        data mesh every rank calls it: the feature is computed split, and
        every rank sweeps every RIR."""
        cfg = self.audio_model.config
        o = dataset.outputs
        n = len(o.audio_filenames)
        if n == 0:
            return {}
        chunk = min(n, chunk)
        log_all = np.asarray(dataset.log_stft, np.float32)
        angles = self._sweep_angles((chunk, *log_all.shape[1:]), generator,
                                    init_angles)
        evaluator = make_evaluator(cfg.dataset, cfg.fs)
        per_rir, render_time = [], 0.0
        with self._eval_mode():
            synchronize(self.device)
            t0 = time.perf_counter()
            feat = self._grid_feature_eval()
            for i in range(0, n, chunk):
                m = min(chunk, n - i)
                sl = slice(i, i + m)
                outs = self.render_rir_chunk(
                    o.microphone_poses[sl], o.source_poses[sl],
                    o.rotations[sl], log_all[sl], angles[:m], feat)
                synchronize(self.device)
                render_time += time.perf_counter() - t0
                log_pred, mag_pred, mag_gt, wav_pred, wav_gt_istft = (
                    x.float().cpu().numpy() for x in outs)
                for j in range(m):
                    wav_gt_ff = (dataset.waveforms[i + j]
                                 if dataset.waveforms is not None
                                 else wav_gt_istft[j])
                    per_rir.append(evaluator.get_full_metrics(
                        mag_pred[j], mag_gt[j], wav_gt_ff, wav_pred[j],
                        wav_gt_istft[j], log_pred[j], log_all[i + j]))
                synchronize(self.device)
                t0 = time.perf_counter()
        out = {}
        for k in per_rir[0]:
            vals = np.asarray([m2[k] for m2 in per_rir], dtype=np.float64)
            out[k] = float(np.mean(vals))
            out[f"{k}_std"] = float(np.std(vals))
        out["num_rays_per_sec_audio"] = n * cfg.max_len / render_time
        out["fps_audio"] = n / render_time
        return out

    def evaluate_audio_device(self, dataset, chunk: int = 512,
                              generator: torch.Generator | None = None,
                              init_angles=None) -> dict:
        """Every eval RIR on the device: render, Griffin-Lim (prediction
        only) and the batched T60/EDT/C50 estimators per chunk, the per-RIR
        vectors averaged on the host -> the same keys as the reference's,
        fps_audio over the whole sweep. The batched estimators may flip a
        borderline invalid-T60 flag on a degenerate RIR against the host
        path, which stays the metric of record.

        Under a data mesh every rank calls it: the grid feature is computed
        split by depth over the ranks, and each chunk's RIRs fan out over
        the ranks in contiguous blocks of ceil(m / N) (partition's), each
        with its rows of the chunk's Griffin-Lim angles, and the per-RIR
        vectors are gathered on every rank before the mean. A block short
        of ceil(m / N) is padded with copies of the chunk's last RIR, whose
        results are dropped (as XLA pads an uneven shard), so that no rank
        runs an empty batch."""
        cfg = self.audio_model.config
        o = dataset.outputs
        n = len(o.audio_filenames)
        if n == 0:
            return {}
        chunk = min(n, chunk)
        log_all = np.asarray(dataset.log_stft, np.float32)
        wav_all = (np.asarray(dataset.waveforms, np.float32)
                   if dataset.waveforms is not None
                   else np.zeros((n, cfg.mic_ch, cfg.max_len * cfg.hop_len),
                                 np.float32))
        angles = self._sweep_angles((chunk, *log_all.shape[1:]), generator,
                                    init_angles)
        per_rir: dict[str, list] = {}
        with self._eval_mode():
            synchronize(self.device)
            t0 = time.perf_counter()
            feat = self._grid_feature_eval()
            for i in range(0, n, chunk):
                m = min(chunk, n - i)
                # this rank's rows of the chunk (all of them on one device)
                b = -(-m // self.world)
                lo = self.rank * b
                rows = (slice(lo, lo + b) if lo + b <= m
                        else np.minimum(np.arange(lo, lo + b), m - 1))
                mic, src, rot, gt_log, gt_wav = _as_f32(self.device, *(
                    a[i:i + m][rows] for a in (
                        o.microphone_poses, o.source_poses, o.rotations,
                        log_all, wav_all)))
                mag_pred = log_to_magnitude(self._render_log(feat, mic, src, rot))
                wav_pred = gl_waveforms(cfg, mag_pred, angles[:m][rows])
                vals = device_rir_metrics(wav_pred, gt_wav, mag_pred,
                                          log_to_magnitude(gt_log),
                                          cfg.dataset, cfg.fs)
                for k, v in vals.items():
                    per_rir.setdefault(k, []).append(
                        all_gather_batch(v, self.mesh, n=b * self.world)[:m]
                        .cpu().numpy())
            synchronize(self.device)
            dt = time.perf_counter() - t0
        out = {k: float(np.mean(np.concatenate(v))) for k, v in per_rir.items()}
        out["fps_audio"] = n / dt
        out["num_rays_per_sec_audio"] = n * cfg.max_len / dt
        return out


def device_rir_metrics(wav_pred: torch.Tensor, wav_gt: torch.Tensor,
                       mag_pred: torch.Tensor, mag_gt: torch.Tensor,
                       dataset: str, fs: float) -> dict:
    """Per-RIR metrics of (M, C, L') predicted and (M, C, L) GT waveforms
    with the batched estimators (evaluate_audio_device's body): the
    prediction zero-padded or cut to L; T60 (RAF: 200 Hz highpass, 10 dB;
    else 30 dB) relative error in %, 100 where any channel on either side
    is invalid; the invalid flag; EDT and C50 absolute errors; 2x the
    magnitudes' MSE -> {key: (M,)}."""
    L = wav_gt.shape[-1]
    pad = L - wav_pred.shape[-1]
    wav_pred = (torch.nn.functional.pad(wav_pred, (0, pad)) if pad > 0
                else wav_pred[..., :L])
    if dataset == "RAF":
        t60_gt, t60_pr = (batched_rt60_advance(w, fs) for w in (wav_gt, wav_pred))
    else:
        t60_gt, t60_pr = (batched_rt60(w, fs, decay_db=30.0)
                          for w in (wav_gt, wav_pred))
    invalid = ((t60_gt < -0.5) | (t60_pr < -0.5)).any(dim=-1)
    rel = ((t60_pr - t60_gt).abs() / t60_gt.abs()).mean(dim=-1)
    rel = torch.where(invalid, 1.0, rel)
    edt = (batched_edt(wav_pred, fs) - batched_edt(wav_gt, fs)).abs().mean(dim=-1)
    c50 = (batched_clarity(wav_pred, fs)
           - batched_clarity(wav_gt, fs)).abs().mean(dim=-1)
    quick = ((mag_pred - mag_gt) ** 2).mean(dim=tuple(range(1, mag_pred.ndim))) * 2
    return {"audio_T60_mean_error": rel * 100.0,
            "audio_total_invalids_T60": invalid.float(),
            "audio_EDT": edt, "audio_C50": c50, "audio_mag": quick}
