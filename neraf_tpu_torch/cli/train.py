"""neraf-train for the port (counterpart of neraf_tpu/cli/train.py).

Usage:
    python -m neraf_tpu_torch.cli.train [--dataset RAF|SoundSpaces]
        [--scene NAME] --data-root DIR [--max-iters N] [--load-dir CKPT_DIR]
        [--output-dir DIR] [--run-dir DIR] [--audio-only] [--seed N]
        [--num-devices N] [--streaming on|off|auto] [--set KEY=VALUE ...]

The same flags, config.yml and run directory as the JAX CLI: config.yml,
metrics.jsonl, neraf_models/step-*.pt and eval_images/. Env overrides:
NeRAF_dataset, NeRAF_scene. It runs on the card; `main(argv,
device="cpu")` runs it on the CPU.

--viewer-port serves the HTTP viewer (viz/viewer.py) on the live joint
pipeline while it trains (0 binds a free port; the bound address is
printed): requests queue on a TrainThreadDispatcher and run on the
training thread between steps, pumped at every steps_per_log, and once
more when training ends; the server stops with the run. As in the JAX
CLI, an --audio-only run has no viewer.

When data/streaming.py::should_stream says so (--streaming on, or "auto"
on a split above audio_data.stream_threshold_gb), the train split's
log-STFT stays in host memory and a StreamingAudioSampler (seeded with
--seed, in audio_data.stream_transfer_dtype) feeds each step and eval
batch; a resumed run restarts its sequence from the seed, as the JAX CLI
does.

--num-devices N above 1 trains the joint pipeline on the JAX CLI's 1-D
data mesh as N torch.distributed ranks (parallel/sharding.py), one device
a rank: the calling process is rank 0 and starts ranks 1..N-1 as spawned
processes, and main() returns rank 0's Trainer. On the card every rank
takes a card of its own (NCCL; fewer cards than ranks raise ValueError),
with device="cpu" every rank runs on the CPU (gloo), the ranks splitting
the caller's torch threads. Each step and
on-device eval sweep runs on the global batch (engine/pipeline.py), in
blocks of ceil(n / N) where a count does not divide by N, and the ResNet
runs split by depth over the ranks (parallel/depth_split.py). Rank 0
writes the run directory and serves --viewer-port (its viewer requests
take no collective path); a resume loads on rank 0 and hands its state to
the others. A rank that fails fails the run: rank 0 raises, and the
ranks still running are stopped. As in the JAX CLI, --audio-only runs on
one device whatever --num-devices says (the JAX CLI builds the mesh and
its audio-only branch does not use it).
"""

from __future__ import annotations

import argparse
import multiprocessing
import socket

import torch

from neraf_tpu_torch.configs.config import apply_overrides, default_config
from neraf_tpu_torch.data.streaming import StreamingAudioSampler, should_stream
from neraf_tpu_torch.data.vision_data import camera_arrays
from neraf_tpu_torch.engine.audio_engine import AudioEngine
from neraf_tpu_torch.engine.factory import build_pipeline, load_audio_split
from neraf_tpu_torch.engine.trainer import Trainer
from neraf_tpu_torch.models.audio import AudioModel
from neraf_tpu_torch.parallel.sharding import TIMEOUT, make_mesh
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
                   help="data-parallel size: ranks, one device each "
                        "(default: one device)")
    p.add_argument("--viewer-port", type=int, default=None,
                   help="serve the HTTP viewer during training (0: a free "
                        "port)")
    p.add_argument("--streaming", default=None, choices=["on", "off", "auto"],
                   help="audio data path: the whole split on the device "
                        "(off), host-streamed batches (on), or size-based "
                        "(auto)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="override any config field by dotted path, e.g. "
                        "--set trainer.start_step_audio=0; YAML-parsed "
                        "values; repeatable")
    return p.parse_args(argv)


def audio_source(cfg, split, seed: int, device, mesh=None):
    """(next_audio, sampler): the split on the device, or a streaming
    sampler when should_stream says so (stop it when the run ends); under
    a data mesh the sampler gives the rank's block of each batch."""
    if should_stream(cfg.audio_data, split):
        sampler = StreamingAudioSampler(
            split, cfg.audio_data.batch_size, seed=seed,
            transfer_dtype=cfg.audio_data.stream_transfer_dtype, device=device,
            mesh=mesh)
        return sampler.next, sampler
    arrays = split.slice_arrays(device)
    return (lambda: arrays), None


def main(argv=None, device="cuda") -> Trainer:
    """Train as the JAX CLI does -> the Trainer (its `pipeline` is the
    trained state, its `timings` the host seconds of each step, eval and
    save); rank 0's with --num-devices above 1 (module docstring)."""
    args = parse_args(argv)
    n = args.num_devices or 1
    if n == 1 or args.audio_only:
        return run(args, device)
    ctx = multiprocessing.get_context("spawn")
    init = f"tcp://127.0.0.1:{_free_port()}"
    # CPU ranks share the caller's threads (oversubscribed thread pools
    # stall each other); a card's rank keeps torch's default
    threads = (max(1, torch.get_num_threads() // n)
               if torch.device(device).type == "cpu" else None)
    ranks = [ctx.Process(target=_rank_main,
                         args=(argv, device, r, n, init, threads),
                         name=f"neraf-train rank {r}", daemon=True)
             for r in range(1, n)]
    for p in ranks:
        p.start()
    try:
        trainer = run(args, device, _join_mesh(device, n, 0, init), threads)
    except BaseException:
        _stop(ranks)
        raise
    for p in ranks:
        p.join(TIMEOUT.total_seconds())
    failed = {p.name: p.exitcode for p in ranks if p.exitcode != 0}
    _stop(ranks)
    if failed:
        raise RuntimeError(f"--num-devices {n}: ranks failed: {failed}")
    return trainer


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _join_mesh(device, n: int, rank: int, init: str):
    """Rank `rank` of n: one card each, or every rank on the CPU."""
    devices = ["cpu"] * n if torch.device(device).type == "cpu" else None
    return make_mesh(n, devices, rank=rank, init_method=init)


def _rank_main(argv, device, rank: int, n: int, init: str,
               threads: int | None) -> None:
    """A spawned rank (1..n-1) of main()."""
    run(parse_args(argv), device, _join_mesh(device, n, rank, init), threads)


def _stop(ranks) -> None:
    for p in ranks:
        if p.is_alive():
            p.terminate()
        p.join()


def run(args, device, mesh=None, threads: int | None = None) -> Trainer:
    """One process's run of the parsed flags: the whole run, or under a
    data mesh this rank's (the mesh is left at the end), on `threads`
    torch threads when given."""
    kept = torch.get_num_threads()
    if threads is not None:
        torch.set_num_threads(threads)
    try:
        return _train(args, device, mesh)
    finally:
        torch.set_num_threads(kept)
        if mesh is not None:
            mesh.close()


def _train(args, device, mesh) -> Trainer:
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
        engine = AudioEngine(cfg, AudioModel(cfg.audio_model),
                             audio_train.outputs.aabb, device=device)
        trainer = Trainer(config=cfg, pipeline=engine, output_dir=args.run_dir)
        state, _ = trainer.maybe_resume(engine, args.load_dir)
        next_audio, sampler = audio_source(cfg, audio_train, args.seed, device)
        try:
            trainer.train(
                state,
                step_fn=lambda e: (e, e.train_step(next_audio())),
                eval_fns={"eval_audio": lambda e: e.evaluate(audio_eval)},
                max_steps=args.max_iters,
            )
        finally:
            if sampler is not None:
                sampler.stop()
        return trainer

    bundle = build_pipeline(cfg, device=device, mesh=mesh)
    pipe = bundle.pipeline
    device = pipe.device
    trainer = Trainer(config=cfg, pipeline=pipe, output_dir=args.run_dir,
                      mesh=mesh)
    state, _ = trainer.maybe_resume(pipe, args.load_dir)

    vtrain, veval = bundle.vision_train, bundle.vision_eval
    cam_arrays = camera_arrays(vtrain.cameras, device)
    image_arrays = {"images": torch.as_tensor(vtrain.images, device=device)}
    next_audio, sampler = audio_source(cfg, bundle.audio_train, args.seed,
                                       device, mesh)
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
        if trainer.writes:
            save_eval_images(images, eval_img_dir, step)
        return metrics

    on_metrics = server = None
    if args.viewer_port is not None and trainer.writes:
        dispatcher = TrainThreadDispatcher()
        backend = ViewerBackend(pipe, dispatch=dispatcher)
        server = serve(backend, port=args.viewer_port, blocking=False)

        def on_metrics(step, scalars):
            backend.step_hint = step
            dispatcher.pump()

    try:
        trainer.train(
            state,
            step_fn=lambda p: (p, p.train_step(cam_arrays, next_audio(),
                                               image_arrays)),
            eval_fns=eval_fns,
            eval_batch_fn=lambda p: p.eval_loss_dict(
                eval_cam_arrays, next_audio(), eval_image_arrays),
            eval_image_fn=eval_image_fn,
            max_steps=args.max_iters,
            on_metrics=on_metrics,
        )
    finally:
        if sampler is not None:
            sampler.stop()
        if server is not None:
            server.shutdown()
            server.server_close()
            dispatcher.close()
    return trainer


if __name__ == "__main__":
    main()
