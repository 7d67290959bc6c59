"""The training loop (counterpart of neraf_tpu/engine/trainer.py): the
step cadences of the reference's TrainerConfig, checkpoints, metrics.jsonl,
--load-dir resume and the eval results JSON.

The state is the pipeline or engine object (JointPipeline, AudioEngine),
updated in place by step_fn; its step is `.step`. The loop adds no device
synchronisation of its own: it turns a step's metrics into floats at the
log cadence only (JointPipeline.train_step already returns floats).

`timings` records the host seconds of every step, eval and save, as
(step, what, seconds); a step that returns device tensors is timed as
enqueued, and the device time of the steps since the last
synchronisation shows in the next eval or save.

As in the JAX package, an exception in the loop first saves an emergency
checkpoint of the latest state, and never over a checkpoint of the same
step already on disk. The state is updated in place, so an exception
raised inside step_fn can leave that step partly applied: then nothing is
saved, and a resume starts from the last periodic checkpoint (the JAX
package saves nothing there either, once its step has consumed the
state's buffers).

Under a data mesh (`mesh`, parallel/sharding.py) every rank runs the same
loop and cadence with its own Trainer; rank 0 alone writes the run
directory (config.yml, metrics.jsonl, checkpoints, the emergency
checkpoint); before each periodic save the ranks check that their
replicated state (parallel/sharding.py::replicated_state) is rank 0's,
bitwise, and raise if not, and after it they wait at a barrier. A
resume loads the checkpoint on rank 0, and maybe_resume then hands rank
0's state to every rank (parallel/sharding.py::broadcast_state), with or
without a checkpoint. The checkpoint format does not depend on the number
of ranks.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Callable

from neraf_tpu_torch.configs.config import ExperimentConfig, save_config
from neraf_tpu_torch.engine.checkpoints import (
    checkpoint_path,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from neraf_tpu_torch.parallel.sharding import (
    broadcast_state,
    replica_mismatches,
    replicated_state,
)
from neraf_tpu_torch.utils.writer import MetricsWriter


@dataclasses.dataclass
class Trainer:
    config: ExperimentConfig
    pipeline: Any  # JointPipeline or AudioEngine
    output_dir: Path | None = None
    mesh: Any = None  # parallel/sharding.py's DataMesh of a multi-rank run

    def __post_init__(self):
        cfg = self.config
        if self.output_dir is None:
            stamp = time.strftime("%Y-%m-%d_%H%M%S")
            self.output_dir = (Path(cfg.output_dir) / cfg.experiment_name /
                               cfg.method_name / stamp)
        self.output_dir = Path(self.output_dir)
        self.ckpt_dir = self.output_dir / "neraf_models"
        # rank 0 of a multi-rank run writes the run directory
        self.writes = self.mesh is None or self.mesh.global_rank == 0
        self.writer = MetricsWriter(self.output_dir) if self.writes else None
        self.timings: list[tuple[int, str, float]] = []

    def save_run_config(self):
        if self.writes:
            save_config(self.config, self.output_dir / "config.yml")

    def _write(self, step: int, scalars: dict, prefix: str) -> None:
        if self.writes:
            self.writer.write_scalars(step, scalars, prefix=prefix)

    def maybe_resume(self, state, load_dir: str | None):
        """Restore the latest checkpoint under load_dir into state ->
        (state, its step); (state, 0) without a load_dir. Under a mesh,
        rank 0 restores and every rank then takes rank 0's state."""
        if load_dir is not None:
            path = latest_checkpoint(load_dir)
            if path is None:
                raise FileNotFoundError(f"no checkpoints under {load_dir}")
            if self.writes:
                restore_checkpoint(path, state)
        broadcast_state(state, self.mesh)
        return state, int(state.step) if load_dir is not None else 0

    def _save(self, step: int, state, wait: bool = True) -> None:
        """Rank 0 writes the checkpoint; with `wait`, every rank first
        checks that its replicated state is rank 0's, bitwise (a rank that
        diverged raises on every rank), and waits for the others after."""
        t0 = time.perf_counter()
        if wait and self.mesh is not None:
            bad = replica_mismatches(replicated_state(state), self.mesh)
            if bad:
                raise RuntimeError(f"step {step}: the ranks' {bad} differ "
                                   f"from rank 0's")
        if self.writes:
            save_checkpoint(
                self.ckpt_dir, step, state,
                keep_all=not self.config.trainer.save_only_latest_checkpoint)
        if wait and self.mesh is not None:
            self.mesh.barrier()
        self.timings.append((step, "save", time.perf_counter() - t0))

    def _timed(self, step: int, what: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.timings.append((step, what, time.perf_counter() - t0))
        return out

    def train(
        self,
        state,
        step_fn: Callable[[Any], tuple[Any, dict]],
        eval_fns: dict[str, Callable[[Any], dict]] | None = None,
        eval_batch_fn: Callable[[Any], dict] | None = None,
        eval_image_fn: Callable[[Any, int], dict] | None = None,
        max_steps: int | None = None,
        on_metrics: Callable[[int, dict], None] | None = None,
    ):
        """Run the loop from state.step to max_steps (the config's
        max_num_iterations by default). step_fn(state) -> (state, metrics);
        at steps_per_log the scalars are written and handed to
        on_metrics(step, scalars) (the live viewer's hook); eval_batch_fn at
        steps_per_eval_batch, eval_image_fn at steps_per_eval_image,
        eval_fns (the full sweeps) at steps_per_eval_all_images, a
        checkpoint at steps_per_save and one at max_steps."""
        tcfg = self.config.trainer
        max_steps = tcfg.max_num_iterations if max_steps is None else max_steps
        self.save_run_config()
        self._latest_state = state
        try:
            state = self._loop(state, step_fn, eval_fns or {}, eval_batch_fn,
                               eval_image_fn, int(state.step), max_steps,
                               on_metrics)
        except (KeyboardInterrupt, Exception):
            self._emergency_save(self._latest_state)
            raise
        self._save(max_steps, state)
        return state

    def _emergency_save(self, latest) -> None:
        """Save `latest` (None while a step was running: its state may be
        partly updated) unless its step's checkpoint exists; rank 0 alone,
        without waiting for the others (one of them may have failed)."""
        if not self.writes:
            return
        if latest is None:
            print("no emergency checkpoint: the exception interrupted a step")
            return
        step = int(latest.step)
        if checkpoint_path(self.ckpt_dir, step).exists():
            print(f"no emergency checkpoint: step {step}'s is on disk")
            return
        try:
            self._save(step, latest, wait=False)
            print(f"emergency checkpoint saved at step {step}")
        except Exception as err:  # the original exception is re-raised
            print(f"emergency checkpoint failed: {err!r}")

    def _loop(self, state, step_fn, eval_fns, eval_batch_fn, eval_image_fn,
              start_step, max_steps, on_metrics):
        tcfg = self.config.trainer
        t_last = time.perf_counter()
        for step in range(start_step, max_steps):
            self._latest_state = None
            state, metrics = self._timed(step + 1, "step", step_fn, state)
            self._latest_state = state

            if (step + 1) % tcfg.steps_per_log == 0:
                now = time.perf_counter()
                scalars = {k: float(v) for k, v in metrics.items()}
                scalars["steps_per_sec"] = tcfg.steps_per_log / (now - t_last)
                t_last = now
                self._write(step + 1, scalars, "train")
                if on_metrics is not None:
                    on_metrics(step + 1, scalars)

            if eval_batch_fn is not None and (step + 1) % tcfg.steps_per_eval_batch == 0:
                self._write(step + 1, self._timed(
                    step + 1, "eval_batch", eval_batch_fn, state), "eval_batch")

            if eval_image_fn is not None and (step + 1) % tcfg.steps_per_eval_image == 0:
                self._write(step + 1, self._timed(
                    step + 1, "eval_image", eval_image_fn, state, step + 1),
                    "eval_image")

            if (step + 1) % tcfg.steps_per_eval_all_images == 0:
                for name, fn in eval_fns.items():
                    self._write(step + 1,
                                self._timed(step + 1, name, fn, state), name)

            if (step + 1) % tcfg.steps_per_save == 0:
                self._save(step + 1, state)

        return state

    def write_eval_json(self, results: dict, output_path: str | Path):
        """The eval CLI's --output-path file."""
        output_path = Path(output_path)
        output_path.parent.mkdir(parents=True, exist_ok=True)
        payload = {
            "experiment_name": self.config.experiment_name,
            "method_name": self.config.method_name,
            "results": results,
        }
        with open(output_path, "w") as f:
            json.dump(payload, f, indent=2)
