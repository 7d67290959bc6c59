"""Experiment configuration (the port's copy of neraf_tpu/configs/config.py).

The same plain-dataclass tree with the same defaults, so one configuration
means the same model in both packages (tests/test_torch_train.py compares
the two field by field), plus VisionModelConfig's port-only fields
(PORT_ONLY_VISION: the hash proposal fields and the fields' depths), whose
defaults are the JAX package's model:

1. dataclass defaults (per-component configs below),
2. the experiment header resolved by `default_config(dataset, scene)`:
   per-dataset fs / STFT geometry / per-scene max_len, and the
   `audio_fields` warmup set to `start_step_audio`,
3. the environment variables ``NeRAF_dataset`` and ``NeRAF_scene``.

A run's configuration is saved as config.yml and loaded back
(``save_config`` / ``load_config``): the same file as the JAX package's
while the port-only fields hold their defaults, read and written by
configs/yaml_subset.py (PyYAML is not a dependency of the port).
``apply_overrides`` applies the CLI's dotted-path ``--set`` values.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from neraf_tpu_torch.configs import yaml_subset

# Per-scene STFT frame counts (reference NeRAF_config.py:43)
SOUNDSPACES_MAX_LEN = {
    "office_4": 78,
    "room_2": 84,
    "frl_apartment_2": 107,
    "frl_apartment_4": 103,
    "apartment_2": 86,
    "apartment_1": 101,
}


@dataclass
class AudioModelConfig:
    """Acoustic field model (reference NeRAFAudioModelConfig)."""

    dataset: str = "SoundSpaces"
    use_grid: bool = True
    grid_step: float = 1.0 / 128.0
    n_features: int = 1024
    use_multiple_viewing_directions: bool = True
    loss_factor: float = 1e-3
    max_len: int = 76
    w_field: int = 512
    fs: int = 22050
    criterion: str = "SC+SLMSE"
    n_freq_stft: int = 257
    hop_len: int = 128
    win_len: int = 512
    resnet_backbone: str = "resnet50"

    def resolve(self) -> "AudioModelConfig":
        """Apply the per-dataset derivations (RAF: 48 kHz, 513 bins, mono)."""
        cfg = dataclasses.replace(self)
        if cfg.dataset == "RAF":
            cfg.fs = 48000
            cfg.n_freq_stft = 513
            cfg.hop_len = 256
            cfg.win_len = 512
            cfg.max_len = int(0.32 * cfg.fs) // cfg.hop_len
            cfg.mic_ch = 1
        else:
            cfg.mic_ch = 2
        return cfg

    # populated by resolve()
    mic_ch: int = 2

    @property
    def n_fft(self) -> int:
        return (self.n_freq_stft - 1) * 2


@dataclass
class VisionModelConfig:
    """Nerfacto-class radiance model. The main field's encoding is
    "fourier" or "hash" (the multiresolution hash grid, ported with its CUDA
    kernels); the proposal fields' is "fourier" (F 6, 2 x 128) or "hash"
    (nerfstudio's HashMLPDensityField: a grid of the proposal_* sizes, one
    max_res a proposal, then one ReLU layer of proposal_hidden_dim).
    hash_grad_mode is kept so configurations compare equal and has no
    effect in the port.

    The fields after camera_opt_mode are the port's alone (the JAX package
    has no hash proposal field that builds, and fixed depths); their
    defaults are the JAX package's model, and save_config leaves each out
    while it holds its default (PORT_ONLY_VISION). hidden_layers and
    hidden_layers_color count ReLU layers, where nerfstudio's
    base_mlp_num_layers and num_layers_color count linear ones: Nerfacto's
    published field has 1 and 2."""

    encoding: str = "fourier"  # "fourier" | "hash"
    num_frequencies: int = 10
    base_mlp_width: int = 256
    base_mlp_layers: int = 4
    num_levels: int = 8
    features_per_level: int = 4
    log2_hashmap_size: int = 19
    base_res: int = 16
    max_res: int = 2048
    hash_grad_mode: str = "auto"
    proposal_encoding: str = "fourier"
    pe_mlp_impl: str = "auto"
    hidden_dim: int = 64
    hidden_dim_color: int = 64
    geo_feat_dim: int = 15
    appearance_embed_dim: int = 32
    average_init_density: float = 0.01
    num_nerf_samples: int = 48
    num_proposal_samples: tuple = (256, 96)
    proposal_update_every: int = 5
    proposal_warmup: int = 5000
    use_single_jitter: bool = True
    interlevel_loss_mult: float = 1.0
    distortion_loss_mult: float = 0.002
    eval_num_rays_per_chunk: int = 1 << 15
    background_color: str = "last_sample"
    camera_opt_mode: str = "SO3xR3"
    hidden_layers: int = 2  # the hash main field's base MLP, hidden_dim wide
    hidden_layers_color: int = 3  # the colour head, hidden_dim_color wide
    proposal_num_levels: int = 5
    proposal_features_per_level: int = 2
    proposal_log2_hashmap_size: int = 17
    proposal_base_res: int = 16
    proposal_max_res: tuple = (128, 256)
    proposal_hidden_dim: int = 16


# VisionModelConfig's fields that the JAX package's lacks
PORT_ONLY_VISION = ("hidden_layers", "hidden_layers_color", "proposal_num_levels",
                    "proposal_features_per_level", "proposal_log2_hashmap_size",
                    "proposal_base_res", "proposal_max_res", "proposal_hidden_dim")


@dataclass
class AudioDataConfig:
    data_dir: str = ""
    dataset: str = "SoundSpaces"
    batch_size: int = 2048  # STFT slices per step
    fs: int = 22050
    max_len: int = 78
    hop_len: int = 128
    streaming: str = "auto"
    stream_threshold_gb: float = 8.0
    stream_transfer_dtype: str = "bfloat16"


@dataclass
class VisionDataConfig:
    data_dir: str = ""
    train_rays_per_batch: int = 4096
    eval_rays_per_batch: int = 4096
    eval_mode: str = "filename"
    train_split_fraction: float = 0.9
    downscale_factor: int = 1


@dataclass
class OptimizerGroupConfig:
    lr: float = 1e-2
    eps: float = 1e-15
    lr_final: float = 1e-4
    max_steps: int = 200000
    warmup_steps: int = 0


@dataclass
class OptimizersConfig:
    """The four named Adam groups of the reference (NeRAF_config.py:115-132)."""

    proposal_networks: OptimizerGroupConfig = field(
        default_factory=lambda: OptimizerGroupConfig(lr=1e-2, lr_final=1e-4, max_steps=200000))
    fields: OptimizerGroupConfig = field(
        default_factory=lambda: OptimizerGroupConfig(lr=1e-2, lr_final=1e-4, max_steps=200000))
    audio_fields: OptimizerGroupConfig = field(
        default_factory=lambda: OptimizerGroupConfig(
            lr=1e-4, lr_final=1e-8, max_steps=1002000, warmup_steps=2000))
    camera_opt: OptimizerGroupConfig = field(
        default_factory=lambda: OptimizerGroupConfig(lr=1e-3, lr_final=1e-4, max_steps=5000))


@dataclass
class MeshConfig:
    data_axis: int = -1
    model_axis: int = 1


@dataclass
class TrainerConfig:
    max_num_iterations: int = 400001
    start_step_audio: int = 2000
    steps_per_eval_batch: int = 10000
    steps_per_eval_image: int = 10000
    steps_per_eval_all_images: int = 10000
    steps_per_save: int = 20000
    save_only_latest_checkpoint: bool = False
    mixed_precision: bool = True  # bf16 compute, f32 parameters
    grid_bake_cells_per_step: int = 4096
    steps_per_log: int = 100


@dataclass
class ExperimentConfig:
    method_name: str = "NeRAF"
    experiment_name: str = "experiment"
    dataset: str = "SoundSpaces"
    scene: str = "office_4"
    output_dir: str = "./outputs"
    eval_save_dir: str | None = None
    seed: int = 42

    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    audio_model: AudioModelConfig = field(default_factory=AudioModelConfig)
    vision_model: VisionModelConfig = field(default_factory=VisionModelConfig)
    audio_data: AudioDataConfig = field(default_factory=AudioDataConfig)
    vision_data: VisionDataConfig = field(default_factory=VisionDataConfig)
    optimizers: OptimizersConfig = field(default_factory=OptimizersConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


def default_config(dataset: str | None = None, scene: str | None = None,
                   data_root: str | None = None) -> ExperimentConfig:
    """The experiment config of a dataset/scene pair, with the env-var
    overrides NeRAF_dataset / NeRAF_scene."""
    dataset = os.environ.get("NeRAF_dataset", dataset or "RAF")
    scene = os.environ.get("NeRAF_scene", scene or ("FurnishedRoom" if dataset == "RAF" else "office_4"))

    cfg = ExperimentConfig(dataset=dataset, scene=scene,
                           experiment_name=f"{scene}_NeRAF")
    if dataset == "SoundSpaces":
        fs = 22050
        max_len = SOUNDSPACES_MAX_LEN.get(scene, 78)
        cfg.audio_model = AudioModelConfig(dataset=dataset, fs=fs, max_len=max_len).resolve()
        cfg.audio_data = AudioDataConfig(dataset=dataset, fs=fs, max_len=max_len, hop_len=128)
        cfg.vision_data.eval_mode = "filename"
    else:
        cfg.audio_model = AudioModelConfig(dataset="RAF").resolve()
        cfg.audio_data = AudioDataConfig(dataset="RAF", fs=48000,
                                         max_len=cfg.audio_model.max_len, hop_len=256)
        cfg.vision_data.eval_mode = "fraction"
    cfg.optimizers.audio_fields.warmup_steps = cfg.trainer.start_step_audio

    if data_root is not None:
        base = Path(data_root) / scene
        cfg.audio_data.data_dir = str(base)
        cfg.vision_data.data_dir = str(base)
    return cfg


def _to_dict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj):
        return {f.name: _to_dict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_to_dict(v) for v in obj]
    return obj


def _from_dict(cls, d: dict) -> Any:
    """The dataclass `cls` from a dict; nested dataclasses are resolved by
    field name (_NESTED), lists become tuples, unknown keys are ignored."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if f.name in _NESTED and isinstance(v, dict):
            kwargs[f.name] = _from_dict(_NESTED[f.name], v)
        elif isinstance(v, list):
            kwargs[f.name] = tuple(v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


_NESTED = {
    "trainer": TrainerConfig,
    "audio_model": AudioModelConfig,
    "vision_model": VisionModelConfig,
    "audio_data": AudioDataConfig,
    "vision_data": VisionDataConfig,
    "optimizers": OptimizersConfig,
    "mesh": MeshConfig,
    "proposal_networks": OptimizerGroupConfig,
    "fields": OptimizerGroupConfig,
    "audio_fields": OptimizerGroupConfig,
    "camera_opt": OptimizerGroupConfig,
}


def _field_names(obj) -> list:
    return [f.name for f in dataclasses.fields(obj)] \
        if dataclasses.is_dataclass(obj) else []


def apply_overrides(cfg: ExperimentConfig,
                    overrides: list[str]) -> ExperimentConfig:
    """Apply dotted-path ``key=value`` overrides in place (returns cfg), as
    the JAX package's CLI does: values are YAML 1.1 scalars or flow
    sequences (``true``, ``1e-3``, ``[16, 12]``, quoted strings), lists
    become tuples, a numeric field turns a string such as ``1e-3`` into its
    own type, a str field keeps the literal text of a value that YAML reads
    as a bool or a number (``streaming=off`` stores "off"). An unknown path
    raises ValueError with the valid field names."""
    for item in overrides:
        path, sep, raw = item.partition("=")
        if not sep:
            raise ValueError(f"override {item!r} is not of the form key=value")
        parts = path.strip().split(".")
        obj = cfg
        for i, name in enumerate(parts[:-1]):
            if name not in _field_names(obj):
                raise ValueError(
                    f"override path {'.'.join(parts[:i + 1])!r} not found; "
                    f"valid fields here: {_field_names(obj)}")
            obj = getattr(obj, name)
        leaf = parts[-1]
        if leaf not in _field_names(obj):
            raise ValueError(f"override field {path!r} not found; valid "
                             f"fields: {_field_names(obj)}")
        value = yaml_subset.parse_scalar(raw)
        if isinstance(value, list):
            value = tuple(value)
        current = getattr(obj, leaf)
        if isinstance(value, str) and isinstance(current, (int, float)) \
                and not isinstance(current, bool):
            value = type(current)(float(value))
        elif isinstance(current, str) and not isinstance(value, str) \
                and value is not None:
            value = raw.strip()
        setattr(obj, leaf, value)
    return cfg


def save_config(cfg: ExperimentConfig, path: str | Path) -> None:
    """config.yml: every field, but a port-only one that holds its default,
    so that a configuration the JAX package can express is its file."""
    d = _to_dict(cfg)
    defaults = _to_dict(VisionModelConfig())
    for name in PORT_ONLY_VISION:
        if d["vision_model"][name] == defaults[name]:
            del d["vision_model"][name]
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(yaml_subset.dump(d))


def load_config(path: str | Path) -> ExperimentConfig:
    return _from_dict(ExperimentConfig, yaml_subset.load(Path(path).read_text()))
