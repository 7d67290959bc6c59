"""Build the render pipeline at the repo's two sizes.

The configurations are the ones __graft_entry__._build_pipeline uses:
- full: SoundSpaces, max_len 78, 257 bins, w_field 512, resnet50 with
  n_features 1024, a 7 x grid_res^3 grid, audio AABB +-3;
- tiny: resnet18, w_field 32, max_len 12 (grid_res is the caller's, 16 in
  the tests).
"""

from __future__ import annotations

import torch

from neraf_tpu.configs.config import AudioModelConfig, ExperimentConfig
from neraf_tpu_torch.bridge import load_render_params
from neraf_tpu_torch.engine.pipeline import RenderPipeline
from neraf_tpu_torch.models.audio import AudioModel
from neraf_tpu_torch.models.grid import init_grid
from neraf_tpu_torch.models.resnet3d import ResNet3D

AUDIO_AABB = ((-3.0, -3.0, -3.0), (3.0, 3.0, 3.0))


def build_render_pipeline(grid_res: int = 128, tiny: bool = False,
                          device="cpu", seed: int = 0,
                          mixed_precision: bool | None = None,
                          params: dict | None = None, batch_stats=None,
                          grid=None) -> RenderPipeline:
    """A RenderPipeline with weights from `seed` (flax's initialisers, drawn
    from a CPU torch.Generator, so the same seed gives the same weights on
    every device), or bridged from a JAX train state's `params` and
    `batch_stats`. mixed_precision None keeps the config's default (bf16)."""
    cfg = ExperimentConfig(dataset="SoundSpaces")
    if tiny:
        cfg.audio_model = AudioModelConfig(
            dataset="SoundSpaces", max_len=12, n_freq_stft=257, w_field=32,
            n_features=1024, resnet_backbone="resnet18").resolve()
    else:
        cfg.audio_model = AudioModelConfig(
            dataset="SoundSpaces", max_len=78, n_freq_stft=257, w_field=512,
            n_features=1024, resnet_backbone="resnet50").resolve()
    if mixed_precision is not None:
        cfg.trainer.mixed_precision = mixed_precision
    acfg = cfg.audio_model
    resnet = ResNet3D(backbone=acfg.resnet_backbone, n_features=acfg.n_features)
    audio_model = AudioModel(acfg, grid_feature_dim=resnet.feature_dim)
    if params is None:
        gen = torch.Generator().manual_seed(seed)
        resnet.reset_parameters(gen)
        audio_model.field.reset_parameters(gen)
    else:
        load_render_params(resnet, audio_model.field, params, batch_stats)
    return RenderPipeline(
        cfg, resnet, audio_model, torch.tensor(AUDIO_AABB),
        init_grid(grid_res) if grid is None else grid, grid_res, device)
