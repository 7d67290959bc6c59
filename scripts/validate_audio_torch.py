"""Audio-only learning validation of the PyTorch port (the counterpart of
scripts/validate_learning.py; no JAX).

The grid-free acoustic field (w_field 512, float32) learns the synthetic
room of data/synthetic.py::synth_scene: 96 train and 8 eval RIRs whose
decay time and direct-path delay follow the mic-source distance. It trains
through AudioEngine and Trainer for `--steps` steps of 2048 STFT slices
with scripts/validate_learning.py's configuration (Adam lr 5e-4, no
warmup), evaluates before and after, and applies that script's gate: the
trained quick_audio_mag below half the untrained one. Prints the untrained
/ trained table beside the reference's trained column (VALIDATION.md) and
the steps/s; the run directory goes to a temporary directory, removed at
the end.

Run from the repository root on a card:

    PYTHONPATH=. python scripts/validate_audio_torch.py [--steps 1500] [--seeds 0 1]

Exits 1 when a gate fails.
"""

from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
import time

import torch

from neraf_tpu_torch.configs.config import AudioModelConfig, ExperimentConfig
from neraf_tpu_torch.data.synthetic import synth_scene
from neraf_tpu_torch.engine.audio_engine import AudioEngine
from neraf_tpu_torch.engine.pipeline import synchronize
from neraf_tpu_torch.engine.trainer import Trainer
from neraf_tpu_torch.models.audio import AudioModel

# VALIDATION.md:7-11, the JAX package's trained column (1500 steps)
REFERENCE = {"audio_T60_mean_error": 3.9353, "audio_total_invalids_T60": 0.0,
             "audio_EDT": 0.0126, "audio_C50": 0.7978, "quick_audio_mag": 0.9950}


def validation_config(steps: int, seed: int) -> ExperimentConfig:
    """scripts/validate_learning.py:93-101's configuration."""
    cfg = ExperimentConfig(dataset="SoundSpaces", seed=seed)
    cfg.audio_model = AudioModelConfig(
        dataset="SoundSpaces", max_len=60, n_freq_stft=257, w_field=512,
        use_grid=False).resolve()
    cfg.audio_data.batch_size = 2048
    cfg.optimizers.audio_fields.warmup_steps = 0
    cfg.optimizers.audio_fields.lr = 5e-4
    cfg.optimizers.audio_fields.max_steps = max(steps, 1)
    cfg.trainer.steps_per_log = 250
    cfg.trainer.steps_per_save = cfg.trainer.steps_per_eval_all_images = steps + 1
    return cfg


def run(steps: int, seed: int, n_train: int = 96, n_eval: int = 8,
        device="cuda") -> dict:
    """Evaluate, train, evaluate -> the metrics before and after, steps/s
    and the gate."""
    cfg = validation_config(steps, seed)
    train_ds = synth_scene(n_train, max_len=cfg.audio_model.max_len, seed=0)
    eval_ds = synth_scene(n_eval, max_len=cfg.audio_model.max_len, seed=1)
    eval_ds.outputs.aabb = train_ds.outputs.aabb
    engine = AudioEngine(cfg, AudioModel(cfg.audio_model),
                         train_ds.outputs.aabb, device=device)
    arrays = train_ds.slice_arrays(device)
    before = engine.evaluate(eval_ds)

    run_dir = tempfile.mkdtemp(prefix="validate_audio_")
    try:
        trainer = Trainer(config=cfg, pipeline=engine, output_dir=run_dir)
        synchronize(engine.device)
        t0 = time.perf_counter()
        trainer.train(engine, step_fn=lambda e: (e, e.train_step(arrays)),
                      max_steps=steps)
        synchronize(engine.device)
        saves = sum(dt for _, what, dt in trainer.timings if what == "save")
        dt = time.perf_counter() - t0 - saves
        trainer.writer.close()
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    after = engine.evaluate(eval_ds)
    gate = after["quick_audio_mag"] < before["quick_audio_mag"] * 0.5
    return {"before": before, "after": after, "steps_per_s": steps / dt,
            "seconds": dt, "gate": gate}


def table(res: dict, steps: int, seed: int) -> str:
    rows = [f"seed {seed}: {steps} steps in {res['seconds']:.1f} s @ "
            f"{res['steps_per_s']:.1f} steps/s",
            "",
            "| metric | untrained | trained | reference trained |",
            "|---|---|---|---|"]
    for k, ref in REFERENCE.items():
        rows.append(f"| {k} | {res['before'][k]:.4f} | {res['after'][k]:.4f} "
                    f"| {ref:.4f} |")
    return "\n".join(rows)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1],
                   help="weights and train generator (the scene is fixed)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("validate_audio_torch: no CUDA device", file=sys.stderr)
        return 1
    print(f"device: {torch.cuda.get_device_name(0)}")
    ok = True
    for seed in args.seeds:
        res = run(args.steps, seed)
        print(table(res, args.steps, seed))
        print(f"{'PASS' if res['gate'] else 'FAIL'}: seed {seed}: "
              "quick_audio_mag below half the untrained value", flush=True)
        ok &= res["gate"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
