"""neraf-train for the port (counterpart of neraf_tpu/cli/train.py).

Usage:
    python -m neraf_tpu_torch.cli.train [--dataset RAF|SoundSpaces]
        [--scene NAME] --data-root DIR [--max-iters N] [--load-dir CKPT_DIR]
        [--output-dir DIR] [--run-dir DIR] [--audio-only] [--seed N]
        [--streaming on|off|auto] [--set KEY=VALUE ...]

The same flags, config.yml and run directory as the JAX CLI: config.yml,
metrics.jsonl, neraf_models/step-*.pt and eval_images/. Env overrides:
NeRAF_dataset, NeRAF_scene. It runs on the card; `main(argv,
device="cpu")` runs it on the CPU.

--viewer-port serves the HTTP viewer (viz/viewer.py) on the live joint
pipeline while it trains (0 binds a free port; the bound address is
printed): requests queue on a TrainThreadDispatcher and run on the
training thread between steps, pumped at every steps_per_log, and once
more when training ends; the server stops with the run. As in the JAX
CLI, an --audio-only run has no viewer. Flags whose part of the system is
not ported raise NotImplementedError naming the ROADMAP item that ports
it: --num-devices above 1, and a streaming decision that comes out "on".
"""

from __future__ import annotations

import argparse

import torch

from neraf_tpu_torch.configs.config import apply_overrides, default_config
from neraf_tpu_torch.data.streaming import should_stream
from neraf_tpu_torch.data.vision_data import camera_arrays
from neraf_tpu_torch.engine.audio_engine import AudioEngine
from neraf_tpu_torch.engine.factory import build_pipeline, load_audio_split
from neraf_tpu_torch.engine.trainer import Trainer
from neraf_tpu_torch.models.audio import AudioModel
from neraf_tpu_torch.viz.panels import save_eval_images
from neraf_tpu_torch.viz.viewer import TrainThreadDispatcher, ViewerBackend, serve


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="neraf-train")
    p.add_argument("--dataset", default=None, choices=["RAF", "SoundSpaces"])
    p.add_argument("--scene", default=None)
    p.add_argument("--data-root", required=True)
    p.add_argument("--max-iters", type=int, default=None)
    p.add_argument("--load-dir", default=None)
    p.add_argument("--output-dir", default=None)
    p.add_argument("--run-dir", default=None,
                   help="pin the exact run directory (no timestamped subdir)")
    p.add_argument("--audio-only", action="store_true",
                   help="train the grid-free acoustic field only")
    p.add_argument("--num-devices", type=int, default=None,
                   help="data-parallel size (not ported: one device)")
    p.add_argument("--viewer-port", type=int, default=None,
                   help="serve the HTTP viewer during training (0: a free "
                        "port)")
    p.add_argument("--streaming", default=None, choices=["on", "off", "auto"],
                   help="audio data path: the whole split on the device "
                        "(off), host-streamed batches (on, not ported), or "
                        "size-based (auto)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="override any config field by dotted path, e.g. "
                        "--set trainer.start_step_audio=0; YAML-parsed "
                        "values; repeatable")
    return p.parse_args(argv)


def refuse_unported(args) -> None:
    if args.num_devices is not None and args.num_devices > 1:
        raise NotImplementedError(
            "--num-devices > 1: multi-device training is not ported yet "
            "(ROADMAP.md queue 1 item 10)")


def refuse_streaming(cfg, split) -> None:
    if should_stream(cfg.audio_data, split):
        raise NotImplementedError(
            f"audio_data.streaming={cfg.audio_data.streaming!r} streams this "
            "split, and the streaming sampler is not ported yet (ROADMAP.md "
            "queue 1 item 7); set --streaming off to hold it on the device")


def main(argv=None, device="cuda") -> Trainer:
    """Train as the JAX CLI does -> the Trainer (its `pipeline` is the
    trained state, its `timings` the host seconds of each step, eval and
    save)."""
    args = parse_args(argv)
    refuse_unported(args)
    cfg = default_config(args.dataset, args.scene, data_root=args.data_root)
    cfg.seed = args.seed
    if args.output_dir:
        cfg.output_dir = args.output_dir
    if args.audio_only:
        cfg.audio_model.use_grid = False
    if args.streaming is not None:
        cfg.audio_data.streaming = args.streaming
    if args.overrides:
        # last, so that explicit --set values are final
        apply_overrides(cfg, args.overrides)

    if args.audio_only:
        audio_train = load_audio_split(cfg, "train")
        audio_eval = load_audio_split(cfg, "test")
        refuse_streaming(cfg, audio_train)
        engine = AudioEngine(cfg, AudioModel(cfg.audio_model),
                             audio_train.outputs.aabb, device=device)
        trainer = Trainer(config=cfg, pipeline=engine, output_dir=args.run_dir)
        state, _ = trainer.maybe_resume(engine, args.load_dir)
        arrays = audio_train.slice_arrays(device)
        trainer.train(
            state,
            step_fn=lambda e: (e, e.train_step(arrays)),
            eval_fns={"eval_audio": lambda e: e.evaluate(audio_eval)},
            max_steps=args.max_iters,
        )
        return trainer

    bundle = build_pipeline(cfg, device=device)
    refuse_streaming(cfg, bundle.audio_train)
    pipe = bundle.pipeline
    trainer = Trainer(config=cfg, pipeline=pipe, output_dir=args.run_dir)
    state, _ = trainer.maybe_resume(pipe, args.load_dir)

    vtrain, veval = bundle.vision_train, bundle.vision_eval
    cam_arrays = camera_arrays(vtrain.cameras, device)
    image_arrays = {"images": torch.as_tensor(vtrain.images, device=device)}
    audio_arrays = bundle.audio_train.slice_arrays(device)
    eval_cam_arrays = camera_arrays(veval.cameras, device)
    eval_image_arrays = {"images": torch.as_tensor(veval.images, device=device)}
    eval_fns = {
        "eval_vision": lambda p: p.evaluate_vision(eval_cam_arrays, veval.images),
        # the in-training cadence takes the on-device sweep; the eval CLI
        # takes the host estimators (the metric of record)
        "eval_audio": lambda p: p.evaluate_audio_device(bundle.audio_eval),
    }

    n_eval = len(veval.cameras)
    n_eval_audio = len(bundle.audio_eval.outputs.audio_filenames)
    eval_img_dir = trainer.output_dir / "eval_images"

    def eval_image_fn(p, step):
        k = step // cfg.trainer.steps_per_eval_image - 1
        audio_item = None
        if n_eval_audio:
            a, j = bundle.audio_eval, k % n_eval_audio
            audio_item = {"mic_pose": a.outputs.microphone_poses[j],
                          "source_pose": a.outputs.source_poses[j],
                          "rot": a.outputs.rotations[j], "data": a.log_stft[j]}
        metrics, images = p.eval_image(eval_cam_arrays, k % n_eval,
                                       veval.images[k % n_eval],
                                       eval_audio_item=audio_item)
        save_eval_images(images, eval_img_dir, step)
        return metrics

    on_metrics = server = None
    if args.viewer_port is not None:
        dispatcher = TrainThreadDispatcher()
        backend = ViewerBackend(pipe, dispatch=dispatcher)
        server = serve(backend, port=args.viewer_port, blocking=False)

        def on_metrics(step, scalars):
            backend.step_hint = step
            dispatcher.pump()

    try:
        trainer.train(
            state,
            step_fn=lambda p: (p, p.train_step(cam_arrays, audio_arrays,
                                               image_arrays)),
            eval_fns=eval_fns,
            eval_batch_fn=lambda p: p.eval_loss_dict(eval_cam_arrays, audio_arrays,
                                                     eval_image_arrays),
            eval_image_fn=eval_image_fn,
            max_steps=args.max_iters,
            on_metrics=on_metrics,
        )
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
            dispatcher.close()
    return trainer


if __name__ == "__main__":
    main()
