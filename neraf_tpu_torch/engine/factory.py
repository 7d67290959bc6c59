"""Build the pipelines at the repo's two sizes.

The RIR configurations are the ones __graft_entry__._build_pipeline uses:
- full: SoundSpaces, max_len 78, 257 bins, w_field 512, resnet50 with
  n_features 1024, a 7 x grid_res^3 grid, audio AABB +-3;
- tiny: resnet18, w_field 32, max_len 12 (grid_res is the caller's, 16 in
  the tests).
The vision model, with 8 cameras, near 0.05 and far 1000 as there:
- full: VisionModelConfig() defaults (fourier F 10, base MLP 4 x 256, geo
  15, head 3 x 64, appearance 32, proposals F 6 at 2 x 128, samples
  (256, 96) -> 48);
- tiny: F 4, base 2 x 32, geo 7, head 16, appearance 4, samples
  (16, 12) -> 8 (the proposals keep their fixed F 6 at 2 x 128).
encoding="hash" puts the main field on the hash grid, as the JAX CLI's
`--set vision_model.encoding=hash` does: at full width the JAX defaults (8
levels x 4 features, 2^19 rows a level, resolutions 16-2048, base MLP 2 x
64); tiny: 4 levels x 2 features, 2^10 rows, resolutions 4-32 (two dense
levels, two hashed), base MLP 2 x 16. The proposals stay fourier.
The joint train step trains both: full as __graft_entry__ and bench.py
(4096 rays, 2048 STFT slices and 4096 grid cells a step, audio from step
2001); tiny with 64 rays, 32 slices and 256 cells a step, audio from step 2.

build_pipeline is the CLI's (counterpart of neraf_tpu/engine/factory.py):
any ExperimentConfig, with the scene read from disk: the number of cameras
from the train split, the audio AABB from the audio parser, grid_res =
round(1 / grid_step), bf16 under trainer.mixed_precision, weights and the
train generator from config.seed.

Both joint builders take a data mesh (parallel/sharding.py, `mesh`): the
pipeline is then one rank's, on the rank's device, and its step and device
eval sweep run on the global batch over the ranks (engine/pipeline.py).
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from neraf_tpu_torch.configs.config import (
    AudioModelConfig,
    ExperimentConfig,
    VisionModelConfig,
)
from neraf_tpu_torch.data.datasets import (
    AudioSliceDataset,
    load_raf_dataset,
    load_soundspaces_dataset,
)
from neraf_tpu_torch.data.vision_data import VisionDataset, load_transforms
from neraf_tpu_torch.bridge import (
    load_joint_state,
    load_render_params,
    load_vision_params,
)
from neraf_tpu_torch.engine.pipeline import (
    JointPipeline,
    RenderPipeline,
    VisionPipeline,
)
from neraf_tpu_torch.models.audio import AudioModel
from neraf_tpu_torch.models.grid import init_grid
from neraf_tpu_torch.models.resnet3d import ResNet3D
from neraf_tpu_torch.models.vision import VisionModel

AUDIO_AABB = ((-3.0, -3.0, -3.0), (3.0, 3.0, 3.0))
VISION_AABB = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
NUM_CAMERAS, NEAR, FAR = 8, 0.05, 1000.0


def vision_model_config(tiny: bool = False,
                        encoding: str = "fourier") -> VisionModelConfig:
    cfg = VisionModelConfig() if not tiny else VisionModelConfig(
        num_frequencies=4, base_mlp_width=32, base_mlp_layers=2,
        geo_feat_dim=7, hidden_dim_color=16, appearance_embed_dim=4,
        num_nerf_samples=8, num_proposal_samples=(16, 12))
    if encoding == "fourier":
        return cfg
    if encoding != "hash":
        raise ValueError(f"encoding={encoding!r}: 'fourier' or 'hash'")
    if not tiny:
        return dataclasses.replace(cfg, encoding="hash")
    return dataclasses.replace(
        cfg, encoding="hash", num_levels=4, features_per_level=2,
        log2_hashmap_size=10, base_res=4, max_res=32, hidden_dim=16)


def audio_model_config(tiny: bool = False) -> AudioModelConfig:
    if tiny:
        return AudioModelConfig(
            dataset="SoundSpaces", max_len=12, n_freq_stft=257, w_field=32,
            n_features=1024, resnet_backbone="resnet18").resolve()
    return AudioModelConfig(
        dataset="SoundSpaces", max_len=78, n_freq_stft=257, w_field=512,
        n_features=1024, resnet_backbone="resnet50").resolve()


def joint_config(tiny: bool = False,
                 encoding: str = "fourier") -> ExperimentConfig:
    """The joint step's configuration (module docstring)."""
    cfg = ExperimentConfig(dataset="SoundSpaces")
    cfg.vision_model = vision_model_config(tiny, encoding)
    cfg.audio_model = audio_model_config(tiny)
    if tiny:
        cfg.vision_data.train_rays_per_batch = 64
        cfg.audio_data.batch_size = 32
        cfg.trainer.grid_bake_cells_per_step = 256
        cfg.trainer.start_step_audio = 1
    return cfg


def build_render_pipeline(grid_res: int = 128, tiny: bool = False,
                          device="cuda", seed: int = 0,
                          mixed_precision: bool | None = None,
                          params: dict | None = None, batch_stats=None,
                          grid=None) -> RenderPipeline:
    """A RenderPipeline with weights from `seed` (flax's initialisers, drawn
    from a CPU torch.Generator, so the same seed gives the same weights on
    every device), or bridged from a JAX train state's `params` and
    `batch_stats`. mixed_precision None keeps the config's default (bf16)."""
    cfg = ExperimentConfig(dataset="SoundSpaces")
    cfg.audio_model = audio_model_config(tiny)
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


def build_vision_pipeline(tiny: bool = False, device="cuda", seed: int = 0,
                          mixed_precision: bool | None = None,
                          params: dict | None = None,
                          encoding: str = "fourier") -> VisionPipeline:
    """A VisionPipeline with weights from `seed` (flax's initialisers from a
    CPU torch.Generator), or bridged from a JAX train state's `params`
    (proposal_networks and fields). mixed_precision None keeps the config's
    default (bf16); encoding is the main field's, "fourier" or "hash"."""
    cfg = ExperimentConfig(dataset="SoundSpaces")
    cfg.vision_model = vision_model_config(tiny, encoding)
    if mixed_precision is not None:
        cfg.trainer.mixed_precision = mixed_precision
    dtype = torch.bfloat16 if cfg.trainer.mixed_precision else torch.float32
    model = VisionModel(cfg.vision_model, num_cameras=NUM_CAMERAS, near=NEAR,
                        far=FAR, dtype=dtype)
    if params is None:
        model.reset_parameters(torch.Generator().manual_seed(seed))
    else:
        load_vision_params(model, params)
    return VisionPipeline(cfg, model, device)


def build_joint_pipeline(grid_res: int = 128, tiny: bool = False,
                         device="cuda", seed: int = 0,
                         mixed_precision: bool | None = None,
                         state=None, encoding: str = "fourier",
                         config: ExperimentConfig | None = None,
                         mesh=None) -> JointPipeline:
    """A JointPipeline with weights from `seed` (flax's initialisers from a
    CPU torch.Generator, zero camera corrections, an empty grid at cursor
    and step 0), or from a JAX JointTrainState's arrays: params (all four
    groups), batch_stats, the four groups' Adam states, grid, cursor and
    step (bridge.load_joint_state). mixed_precision None keeps the config's default (bf16);
    encoding is the main field's, "fourier" or "hash". `config` replaces
    joint_config(tiny, encoding) (a configuration with overrides applied).
    Under a data mesh the pipeline is the rank's, on its device."""
    cfg = joint_config(tiny, encoding) if config is None else copy.deepcopy(config)
    if mixed_precision is not None:
        cfg.trainer.mixed_precision = mixed_precision
    pipe = _joint_pipeline(cfg, NUM_CAMERAS, AUDIO_AABB, grid_res, device, seed,
                           mesh)
    if state is not None:
        load_joint_state(pipe, state)
    return pipe


def _joint_pipeline(cfg: ExperimentConfig, num_cameras: int, audio_aabb,
                    grid_res: int, device, seed: int,
                    mesh=None) -> JointPipeline:
    """The three models' weights from `seed` (vision, ResNet, acoustic
    field, in that order, from one CPU torch.Generator) in a JointPipeline
    whose train generator is seeded the same, on the mesh's device under a
    data mesh."""
    dtype = torch.bfloat16 if cfg.trainer.mixed_precision else torch.float32
    acfg = cfg.audio_model
    resnet = ResNet3D(backbone=acfg.resnet_backbone, n_features=acfg.n_features)
    audio_model = AudioModel(
        acfg, grid_feature_dim=resnet.feature_dim if acfg.use_grid else 0)
    vision = VisionModel(cfg.vision_model, num_cameras=num_cameras, near=NEAR,
                         far=FAR, dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    vision.reset_parameters(gen)
    resnet.reset_parameters(gen)
    audio_model.field.reset_parameters(gen)
    return JointPipeline(cfg, vision, audio_model, resnet, audio_aabb,
                         VISION_AABB, grid_res,
                         device=device if mesh is None else mesh.device,
                         seed=seed, mesh=mesh)


@dataclasses.dataclass
class PipelineBundle:
    pipeline: JointPipeline
    vision_train: VisionDataset | None
    vision_eval: VisionDataset | None
    audio_train: AudioSliceDataset
    audio_eval: AudioSliceDataset


def load_audio_split(cfg: ExperimentConfig, split: str) -> AudioSliceDataset:
    acfg = cfg.audio_data
    if cfg.dataset == "RAF":
        return load_raf_dataset(acfg.data_dir, split, fs=acfg.fs)
    return load_soundspaces_dataset(
        acfg.data_dir, split, fs=acfg.fs, max_len=acfg.max_len, hop_len=acfg.hop_len)


def build_pipeline(cfg: ExperimentConfig, device="cuda",
                   mesh=None) -> PipelineBundle:
    """Load the scene's splits from disk and build the joint pipeline on
    `device` (module docstring; under a data mesh the rank's pipeline, on
    the rank's device); without a vision data_dir there are no vision
    splits and one camera."""
    audio_train = load_audio_split(cfg, "train")
    audio_eval = load_audio_split(cfg, "test")

    vision_train = vision_eval = None
    num_cameras = 1
    if cfg.vision_data.data_dir:
        vcfg = cfg.vision_data
        vision_train, vision_eval = (load_transforms(
            vcfg.data_dir, split, eval_mode=vcfg.eval_mode,
            train_split_fraction=vcfg.train_split_fraction,
            downscale_factor=vcfg.downscale_factor) for split in ("train", "eval"))
        num_cameras = len(vision_train.cameras)

    pipeline = _joint_pipeline(
        cfg, num_cameras, np.asarray(audio_train.outputs.aabb, np.float32),
        int(round(1.0 / cfg.audio_model.grid_step)), device, cfg.seed, mesh)
    return PipelineBundle(pipeline, vision_train, vision_eval, audio_train,
                          audio_eval)
