"""Joint-pipeline learning validation of the PyTorch port, on a synthetic
audio-visual scene (the counterpart of scripts/validate_joint.py; no JAX).

Scene: a coloured sphere at the origin seen by 12 orbit cameras of 64 x 64
(analytic renders) and distance-dependent synthetic RIRs, 96 train and 8
eval (data/synthetic.py). Trains the full joint pipeline (nerfacto render,
grid bake, ResNet3D-50 conditioning, acoustic field, four optimizer
groups) with the reference's configuration, and checks the reference's own
gates: vision PSNR up by more than 5 dB and the T60 error halved. Prints
the untrained / trained table and steps/s; writes nothing.

Run from the repository root on a card:

    PYTHONPATH=. python scripts/validate_joint_torch.py [--steps 2500] [--seed 0]

Exits 1 when a gate fails.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from neraf_tpu_torch.configs.config import (
    AudioModelConfig,
    ExperimentConfig,
    VisionModelConfig,
)
from neraf_tpu_torch.data.synthetic import make_cameras, synth_scene
from neraf_tpu_torch.data.vision_data import camera_arrays
from neraf_tpu_torch.engine.pipeline import JointPipeline, synchronize
from neraf_tpu_torch.models.audio import AudioModel
from neraf_tpu_torch.models.resnet3d import ResNet3D
from neraf_tpu_torch.models.vision import VisionModel

N_CAMS, SIZE, GRID_RES = 12, 64, 128


def validation_config() -> ExperimentConfig:
    """scripts/validate_joint.py:91-109's configuration."""
    cfg = ExperimentConfig(dataset="SoundSpaces")
    cfg.vision_model = VisionModelConfig(num_nerf_samples=48,
                                         num_proposal_samples=(128, 64),
                                         eval_num_rays_per_chunk=1 << 14)
    cfg.audio_model = AudioModelConfig(
        dataset="SoundSpaces", max_len=60, n_freq_stft=257, w_field=512,
        n_features=1024, resnet_backbone="resnet50").resolve()
    cfg.audio_data.batch_size = 2048
    cfg.vision_data.train_rays_per_batch = 4096
    cfg.trainer.start_step_audio = 100
    cfg.trainer.grid_bake_cells_per_step = 4096
    cfg.optimizers.audio_fields.warmup_steps = 100
    cfg.optimizers.audio_fields.lr = 5e-4
    cfg.optimizers.fields.lr = 5e-3
    cfg.optimizers.proposal_networks.lr = 5e-3
    # synthetic poses are exact: freeze the camera optimizer so eval renders
    # (which use the uncorrected poses) match the optimized scene
    cfg.optimizers.camera_opt.lr = 1e-12
    cfg.optimizers.camera_opt.lr_final = 1e-12
    return cfg


def build_pipeline(cfg: ExperimentConfig, audio_aabb, grid_res: int,
                   device, seed: int) -> JointPipeline:
    """The JointPipeline with flax's initialisers drawn from `seed`."""
    acfg = cfg.audio_model
    dtype = torch.bfloat16 if cfg.trainer.mixed_precision else torch.float32
    resnet = ResNet3D(backbone=acfg.resnet_backbone, n_features=acfg.n_features)
    audio = AudioModel(acfg, grid_feature_dim=resnet.feature_dim)
    vision = VisionModel(cfg.vision_model, num_cameras=N_CAMS, near=0.05,
                         far=20.0, dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    vision.reset_parameters(gen)
    resnet.reset_parameters(gen)
    audio.field.reset_parameters(gen)
    return JointPipeline(cfg, vision, audio, resnet, audio_aabb,
                         ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)), grid_res,
                         device=device, seed=seed)


def run(steps: int, seed: int, cfg: ExperimentConfig, grid_res: int = GRID_RES,
        n_train: int = 96, n_eval: int = 8, size: int = SIZE,
        device="cuda") -> dict:
    """Evaluate, train `steps` joint steps, evaluate again -> the metrics
    before and after, steps/s and the gates."""
    train_audio = synth_scene(n_train, max_len=cfg.audio_model.max_len, seed=0)
    eval_audio = synth_scene(n_eval, max_len=cfg.audio_model.max_len, seed=1)
    eval_audio.outputs.aabb = train_audio.outputs.aabb
    cams, images = make_cameras(N_CAMS, size=size)
    pipe = build_pipeline(cfg, train_audio.outputs.aabb, grid_res, device, seed)
    cam_arrays = camera_arrays(cams, device)
    image_arrays = {"images": torch.as_tensor(images, device=pipe.device)}
    audio_arrays = train_audio.slice_arrays(device)

    before_v = pipe.evaluate_vision(cam_arrays, images[:4])
    before_a = pipe.evaluate_audio(eval_audio)
    print("untrained psnr:", round(before_v["psnr"], 2),
          "T60:", round(before_a["audio_T60_mean_error"], 2), flush=True)

    synchronize(pipe.device)
    t0 = time.perf_counter()
    for i in range(steps):
        metrics = pipe.train_step(cam_arrays, audio_arrays, image_arrays)
        if (i + 1) % 200 == 0:
            print(f"step {i + 1}: rgb={metrics['rgb_loss']:.5f} "
                  f"audio_mag={metrics['audio_mag_loss']:.6f}", flush=True)
    synchronize(pipe.device)
    dt = time.perf_counter() - t0
    print(f"{steps} joint steps in {dt:.1f}s ({steps / dt:.2f} steps/s)")

    after_v = pipe.evaluate_vision(cam_arrays, images[:4],
                                   use_average_appearance=False)
    after_v_avg = pipe.evaluate_vision(cam_arrays, images[:4])
    after_a = pipe.evaluate_audio(eval_audio)
    print("psnr with avg appearance:", round(after_v_avg["psnr"], 2))
    print("trained psnr:", round(after_v["psnr"], 2),
          "T60:", round(after_a["audio_T60_mean_error"], 2),
          "EDT:", round(after_a["audio_EDT"], 4))
    gates = {
        "vision learns (psnr +5 dB)": after_v["psnr"] > before_v["psnr"] + 5,
        "audio learns (T60 error halved)": (
            after_a["audio_T60_mean_error"]
            < before_a["audio_T60_mean_error"] * 0.5),
    }
    return {"before_v": before_v, "before_a": before_a, "after_v": after_v,
            "after_v_avg": after_v_avg, "after_a": after_a,
            "steps_per_s": steps / dt, "gates": gates}


def table(res: dict, steps: int) -> str:
    bv, ba, av, aa = (res[k] for k in ("before_v", "before_a", "after_v",
                                      "after_a"))
    return "\n".join([
        f"{steps} steps @ {res['steps_per_s']:.2f} steps/s, grid "
        f"{GRID_RES}^3, resnet50, sphere scene ({N_CAMS} views, {SIZE}x{SIZE})"
        " + synthetic distance-dependent RIRs",
        "",
        "| metric | untrained | trained |",
        "|---|---|---|",
        f"| psnr | {bv['psnr']:.2f} | {av['psnr']:.2f} |",
        f"| psnr (average appearance) | {bv['psnr']:.2f} | "
        f"{res['after_v_avg']['psnr']:.2f} |",
        f"| ssim | {bv['ssim']:.3f} | {av['ssim']:.3f} |",
        f"| audio_T60_mean_error | {ba['audio_T60_mean_error']:.2f} | "
        f"{aa['audio_T60_mean_error']:.2f} |",
        f"| audio_total_invalids_T60 | {ba['audio_total_invalids_T60']:.3f} | "
        f"{aa['audio_total_invalids_T60']:.3f} |",
        f"| audio_EDT | {ba['audio_EDT']:.4f} | {aa['audio_EDT']:.4f} |",
        f"| audio_C50 | {ba['audio_C50']:.3f} | {aa['audio_C50']:.3f} |",
    ])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=2500)
    p.add_argument("--seed", type=int, default=0,
                   help="weights and train generator (the scene is fixed)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("validate_joint_torch: no CUDA device", file=sys.stderr)
        return 1
    res = run(args.steps, args.seed, validation_config())
    print(f"device: {torch.cuda.get_device_name(0)}, seed {args.seed}")
    print(table(res, args.steps))
    for gate, ok in res["gates"].items():
        print(f"{'PASS' if ok else 'FAIL'}: {gate}")
    return 0 if all(res["gates"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
