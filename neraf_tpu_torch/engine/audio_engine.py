"""The audio-only engine (counterpart of neraf_tpu/engine/audio_engine.py):
the grid-free acoustic field, trained on STFT slices and evaluated with
Griffin-Lim and the room-acoustics metrics.

The engine is the train state: the model's weights, one ScheduledAdam on
`audio_fields`, the train generator and the step, updated in place by
train_step. Compute is float32, as the JAX engine's model (it is built
without a compute dtype); TF32 is off.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from neraf_tpu_torch.configs.config import ExperimentConfig
from neraf_tpu_torch.data.loader import gather_audio_batch, sample_audio_indices
from neraf_tpu_torch.dsp.griffin_lim import random_angles
from neraf_tpu_torch.dsp.stft import log_to_magnitude
from neraf_tpu_torch.engine.optimizers import ScheduledAdam
from neraf_tpu_torch.engine.pipeline import _as_f32, gl_waveforms, synchronize
from neraf_tpu_torch.metrics.evaluators import make_evaluator
from neraf_tpu_torch.models.audio import AudioModel


class AudioEngine:
    """Weights from config.seed (flax's initialisers from a CPU
    torch.Generator), then moved to `device`; the train generator seeded
    the same."""

    def __init__(self, config: ExperimentConfig, model: AudioModel, aabb,
                 device="cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if model.grid_feature_dim:
            raise ValueError("AudioEngine trains the grid-free field "
                             "(AudioModel with grid_feature_dim=0)")
        seed = config.seed
        self.config = config
        self.device = torch.device(device)
        model.field.reset_parameters(torch.Generator().manual_seed(seed))
        self.model = model.to(self.device).train()
        self.aabb = torch.as_tensor(np.asarray(aabb, np.float32), device=self.device)
        self.optimizers = {"audio_fields": ScheduledAdam(
            self.model.parameters(), config.optimizers.audio_fields)}
        self.models = {"audio_model": self.model}
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.step = 0

    def train_step(self, arrays: dict, indices=None) -> dict:
        """One step on a batch of audio_data.batch_size STFT slices of the
        device-resident split `arrays` (data/loader.py::audio_arrays), drawn
        from the engine's generator, or the (rec, t) `indices` given ->
        the loss terms and total_loss as device scalars."""
        if indices is None:
            indices = sample_audio_indices(
                arrays["log_stft"].shape[0], self.model.config.max_len,
                self.config.audio_data.batch_size, self.generator, self.device)
        rec, t = (torch.as_tensor(i, device=self.device) for i in indices)
        batch = gather_audio_batch(arrays, rec, t)
        losses = self.model.loss(self.model(batch, self.aabb), batch["data"])
        total = sum(losses.values())
        opt = self.optimizers["audio_fields"]
        opt.opt.zero_grad(set_to_none=True)
        total.backward()
        opt.step()
        self.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        return metrics

    @torch.no_grad()
    def evaluate(self, dataset, chunk: int = 512, init_angles=None) -> dict:
        """Every RIR of the split, in chunks: rendered over all T frames,
        Griffin-Limed on the device (prediction and GT from the same
        angles: two launches a chunk), the full metrics on the host per RIR
        -> the mean and `_std` of each, the chunk-weighted mean of the quick
        STFT metrics (`quick_*`), and fps_audio / num_rays_per_sec_audio
        over the render time (device synchronised before each clock read).
        Every chunk starts from the same angles: `init_angles`, or drawn at
        the chunk's shape from a generator seeded 0 (the JAX engine's
        PRNGKey(0))."""
        cfg = self.model.config
        o = dataset.outputs
        n = len(o.audio_filenames)
        if n == 0:
            return {}
        chunk = min(n, chunk)
        log_all = np.asarray(dataset.log_stft, np.float32)
        if init_angles is not None:
            angles = torch.as_tensor(init_angles, device=self.device).to(
                torch.complex64)
        else:
            angles = random_angles(
                (chunk, *log_all.shape[1:]),
                torch.Generator(device=self.device).manual_seed(0), self.device)
        evaluator = make_evaluator(cfg.dataset, cfg.fs)
        per_rir, quick, render_time = [], {}, 0.0
        for i in range(0, n, chunk):
            m = min(chunk, n - i)
            sl = slice(i, i + m)
            mic, src, rot, gt_log = _as_f32(
                self.device, o.microphone_poses[sl], o.source_poses[sl],
                o.rotations[sl], log_all[sl])
            synchronize(self.device)
            t0 = time.perf_counter()
            log_pred = self.model.render_rirs_batch(mic, src, rot, self.aabb)
            mag_pred, mag_gt = log_to_magnitude(log_pred), log_to_magnitude(gt_log)
            wav_pred = gl_waveforms(cfg, mag_pred, angles[:m])
            wav_gt_istft = gl_waveforms(cfg, mag_gt, angles[:m])
            synchronize(self.device)
            render_time += time.perf_counter() - t0
            log_pred, mag_pred, mag_gt, wav_pred, wav_gt_istft = (
                x.cpu().numpy() for x in (log_pred, mag_pred, mag_gt, wav_pred,
                                          wav_gt_istft))
            for j in range(m):
                wav_gt_ff = (dataset.waveforms[i + j]
                             if dataset.waveforms is not None
                             else wav_gt_istft[j])
                per_rir.append(evaluator.get_full_metrics(
                    mag_pred[j], mag_gt[j], wav_gt_ff, wav_pred[j],
                    wav_gt_istft[j], log_pred[j], log_all[i + j]))
            for k, v in evaluator.get_stft_metrics(mag_pred, mag_gt).items():
                quick[f"quick_{k}"] = quick.get(f"quick_{k}", 0.0) + float(v) * m
        out = {}
        for k in per_rir[0]:
            vals = np.asarray([r[k] for r in per_rir], dtype=np.float64)
            out[k] = float(np.mean(vals))
            out[f"{k}_std"] = float(np.std(vals))
        out["num_rays_per_sec_audio"] = n * cfg.max_len / render_time
        out["fps_audio"] = n / render_time
        for k, v in quick.items():
            out[k] = v / n
        return out
