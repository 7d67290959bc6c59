"""neraf-eval for the port (counterpart of neraf_tpu/cli/evaluate.py).

Usage:
    python -m neraf_tpu_torch.cli.evaluate --load-config RUN_DIR/config.yml
        [--load-dir CKPT_DIR] [--output-path results.json]
        [--render-output-path DIR] [--set KEY=VALUE ...]

Loads the run's config.yml (the JAX CLI's too) and the latest checkpoint
under <run dir>/neraf_models (or --load-dir), then evaluates: the vision
eval views and every eval RIR with the host estimators for a joint run,
the audio engine's sweep for an --audio-only run. The results JSON holds
{"experiment_name", "method_name", "results"}. LPIPS is reported as
skipped (no weights; ROADMAP.md queue 1 item 8).

With AVN_RENDER_POSES set, the trajectory's poses (data/dataparsers.py,
split "inference") are rendered and each predicted log-STFT written as
stft_{i:05d}.npy under --render-output-path (default <run dir>/renders).
The model keeps the AABB of the scene's train split, the one it was
trained with. It runs on the card; `main(argv, device="cpu")` runs it on
the CPU.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np

from neraf_tpu_torch.configs.config import apply_overrides, load_config
from neraf_tpu_torch.data.dataparsers import parse_raf, parse_soundspaces
from neraf_tpu_torch.data.vision_data import camera_arrays
from neraf_tpu_torch.engine.audio_engine import AudioEngine
from neraf_tpu_torch.engine.checkpoints import latest_checkpoint, restore_checkpoint
from neraf_tpu_torch.engine.factory import build_pipeline, load_audio_split
from neraf_tpu_torch.engine.trainer import Trainer
from neraf_tpu_torch.models.audio import AudioModel
from neraf_tpu_torch.utils.png import quantize_rgb, write_png


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="neraf-eval")
    p.add_argument("--load-config", required=True)
    p.add_argument("--load-dir", default=None,
                   help="checkpoint dir; default <config dir>/neraf_models")
    p.add_argument("--output-path", default=None)
    p.add_argument("--render-output-path", default=None)
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="override loaded-config fields by dotted path; "
                        "model-architecture fields must match the checkpoint")
    return p.parse_args(argv)


def restore_latest(args, run_dir: Path, obj) -> None:
    """The latest checkpoint under --load-dir (default <run dir>/neraf_models)
    into obj (a pipeline or engine)."""
    ckpt_dir = Path(args.load_dir) if args.load_dir else run_dir / "neraf_models"
    path = latest_checkpoint(ckpt_dir)
    if path is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    restore_checkpoint(path, obj)


def _eval_audio_only(cfg, run_dir: Path, args, device) -> dict:
    audio_train = load_audio_split(cfg, "train")
    audio_eval = load_audio_split(cfg, "test")
    engine = AudioEngine(cfg, AudioModel(cfg.audio_model),
                         audio_train.outputs.aabb, device=device)
    restore_latest(args, run_dir, engine)
    results = engine.evaluate(audio_eval)
    if args.output_path:
        Trainer(config=cfg, pipeline=engine, output_dir=run_dir).write_eval_json(
            results, args.output_path)
    print(results)
    return results


def _save_stfts(log_pred, out_dir: Path, prefix: str) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    for i, x in enumerate(log_pred.float().cpu().numpy()):
        np.save(out_dir / f"{prefix}_{i:05d}.npy", x)


def main(argv=None, device="cuda") -> dict:
    """Evaluate as the JAX CLI does -> the results dict."""
    args = parse_args(argv)
    cfg = load_config(args.load_config)
    if args.overrides:
        apply_overrides(cfg, args.overrides)
    run_dir = Path(args.load_config).parent

    if not cfg.audio_model.use_grid:
        return _eval_audio_only(cfg, run_dir, args, device)

    print("lpips: SKIPPED — LPIPS is not ported (ROADMAP.md queue 1 item 8); "
          "the results' lpips is null", flush=True)
    bundle = build_pipeline(cfg, device=device)
    pipe = bundle.pipeline
    restore_latest(args, run_dir, pipe)
    trainer = Trainer(config=cfg, pipeline=pipe, output_dir=run_dir)
    results = {}

    if "AVN_RENDER_POSES" in os.environ:
        parse = parse_raf if cfg.dataset == "RAF" else parse_soundspaces
        o = parse(cfg.audio_data.data_dir, "inference")
        log_pred = pipe.render_rirs(o.microphone_poses, o.source_poses,
                                    o.rotations)
        _save_stfts(log_pred, Path(args.render_output_path or run_dir / "renders"),
                    "stft")
        results["num_rendered"] = int(log_pred.shape[0])
    else:
        veval = bundle.vision_eval
        if veval is not None and len(veval.cameras):
            results.update(pipe.evaluate_vision(
                camera_arrays(veval.cameras, device), veval.images))
        results.update(pipe.evaluate_audio(bundle.audio_eval))

        if args.render_output_path:
            out_dir = Path(args.render_output_path)
            o = bundle.audio_eval.outputs
            _save_stfts(pipe.render_rirs(o.microphone_poses, o.source_poses,
                                         o.rotations), out_dir, "stft_eval")
            if veval is not None and len(veval.cameras):
                cams = camera_arrays(veval.cameras, device)
                H, W = veval.cameras.height, veval.cameras.width
                for i in range(len(veval.cameras)):
                    write_png(out_dir / f"eval_img_{i:04d}.png", quantize_rgb(
                        pipe.render_image(cams, i, H, W)["rgb"]))

    if args.output_path:
        trainer.write_eval_json(results, args.output_path)
    print(results)
    return results


if __name__ == "__main__":
    main()
