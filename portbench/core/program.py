"""The program under test, built from a configuration file's "model"
section: the port's ExperimentConfig holds the file's numbers, and the
port's own modules and pipelines are built from it on the card.

The weights the modules start with are overwritten by the run's own
(portbench/core/inputs.py); a file whose shapes the port's modules do not
take fails there, when the weights are loaded, and a number that the port
takes but computes otherwise fails the comparison with the reference.
"""

from __future__ import annotations

import torch


def experiment_config(spec: dict):
    """The port's ExperimentConfig with the file's numbers: the models,
    the audio data's geometry, the step's batch and the Adam groups."""
    from neraf_tpu_torch.configs.config import (
        AudioDataConfig,
        AudioModelConfig,
        ExperimentConfig,
        OptimizerGroupConfig,
        VisionModelConfig,
    )

    v, a = spec["vision"], spec["audio"]
    cfg = ExperimentConfig(dataset=a["dataset"])
    cfg.trainer.mixed_precision = spec["mixed_precision"]
    h = v["hash"]
    cfg.vision_model = VisionModelConfig(
        encoding=v["encoding"], num_frequencies=v["num_frequencies"],
        base_mlp_width=v["base_mlp_width"], base_mlp_layers=v["base_mlp_layers"],
        num_levels=h["num_levels"], features_per_level=h["features_per_level"],
        log2_hashmap_size=h["log2_hashmap_size"], base_res=h["base_res"],
        max_res=h["max_res"], hidden_dim=h["hidden_dim"],
        hidden_dim_color=v["hidden_dim_color"], geo_feat_dim=v["geo_feat_dim"],
        appearance_embed_dim=v["appearance_embed_dim"],
        average_init_density=v["average_init_density"],
        num_nerf_samples=v["num_nerf_samples"],
        num_proposal_samples=tuple(v["num_proposal_samples"]),
        interlevel_loss_mult=v["interlevel_loss_mult"],
        distortion_loss_mult=v["distortion_loss_mult"],
        eval_num_rays_per_chunk=v["eval_num_rays_per_chunk"])
    cfg.audio_model = AudioModelConfig(
        dataset=a["dataset"], grid_step=1.0 / a["grid_res"], n_features=a["n_features"],
        loss_factor=a["loss_factor"], max_len=a["max_len"], w_field=a["w_field"],
        fs=a["fs"], n_freq_stft=a["n_freq_stft"], hop_len=a["hop_len"],
        win_len=a["win_len"], resnet_backbone=a["resnet"], mic_ch=a["mic_ch"])
    if cfg.audio_model.n_fft != a["n_fft"]:
        raise ValueError(f"n_fft {a['n_fft']} and {a['n_freq_stft']} bins disagree")
    cfg.audio_data = AudioDataConfig(dataset=a["dataset"], fs=a["fs"], max_len=a["max_len"],
                                     hop_len=a["hop_len"])
    t = spec["trainer"]
    cfg.vision_data.train_rays_per_batch = t["train_rays_per_batch"]
    cfg.audio_data.batch_size = t["audio_batch_size"]
    cfg.trainer.grid_bake_cells_per_step = t["grid_bake_cells_per_step"]
    cfg.trainer.start_step_audio = t["start_step_audio"]
    for group, o in spec["optimizers"].items():
        setattr(cfg.optimizers, group, OptimizerGroupConfig(**o))
    return cfg


def render_pipeline(spec: dict, grid: torch.Tensor, device):
    """RenderPipeline (ResNet3D, AudioModel) of the file's audio model over
    `grid`, (R^3, 7)."""
    from neraf_tpu_torch.engine.pipeline import RenderPipeline
    from neraf_tpu_torch.models.audio import AudioModel
    from neraf_tpu_torch.models.resnet3d import ResNet3D

    cfg, a = experiment_config(spec), spec["audio"]
    with torch.device(device):
        resnet = ResNet3D(backbone=a["resnet"], n_features=a["n_features"])
        audio_model = AudioModel(cfg.audio_model, grid_feature_dim=resnet.feature_dim)
    return RenderPipeline(cfg, resnet, audio_model, torch.tensor(a["aabb"]), grid,
                          a["grid_res"], device)


def vision_pipeline(spec: dict, device):
    """VisionPipeline of the file's radiance model."""
    from neraf_tpu_torch.engine.pipeline import VisionPipeline
    from neraf_tpu_torch.models.vision import VisionModel

    cfg, v = experiment_config(spec), spec["vision"]
    dtype = torch.bfloat16 if spec["mixed_precision"] else torch.float32
    with torch.device(device):
        model = VisionModel(cfg.vision_model, num_cameras=v["num_cameras"], near=v["near"],
                            far=v["far"], dtype=dtype)
    return VisionPipeline(cfg, model, device)
