"""Checkpoint save and restore (counterpart of
neraf_tpu/engine/checkpoints.py).

A train state is the pipeline or engine object itself (JointPipeline,
AudioEngine), updated in place; a checkpoint is one torch.save file,
<ckpt_dir>/step-{step:09d}.pt, of plain tensors, ints and dicts, loaded with
weights_only=True:
- models: every module's state_dict (BatchNorm running statistics too);
- optimizers: each ScheduledAdam's torch.optim.Adam state_dict (moments and
  step tensors) and its update count, which sets the learning rate;
- generator: the train generator's state, so that a resumed run draws what
  the straight run draws;
- step, and for a joint pipeline the flat grid and the bake cursor. The
  pipeline's pre-folded grid is derived state: no checkpoint holds it, and
  assigning the restored grid refolds it (JointPipeline.grid), as the JAX
  package refolds on restore (neraf_tpu/engine/checkpoints.py:19, 66-92).
A save writes a temporary file and renames it, so a crash mid-save leaves
the last complete checkpoint as the latest one.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from neraf_tpu_torch.parallel.sharding import (
    gather_model,
    map_model_shards,
    model_shard,
)


def train_state(obj) -> dict:
    """The checkpoint's contents of a pipeline or engine (`models`,
    `optimizers`, `generator`, `step`, and `grid` / `cursor` when it has a
    grid). A pipeline whose acoustic field is sharded over a mesh's model
    axis gathers the shards and their Adam moments (every rank of its
    model row calls this), so the contents are the one-rank format."""
    state = {
        "step": int(obj.step),
        "models": {k: m.state_dict() for k, m in obj.models.items()},
        "optimizers": {k: {"adam": o.opt.state_dict(), "count": o.count}
                       for k, o in obj.optimizers.items()},
        "generator": obj.generator.get_state(),
    }
    if getattr(obj, "grid", None) is not None:
        state["grid"] = obj.grid
        state["cursor"] = int(obj.cursor)
    mesh = getattr(obj, "mesh", None)
    return map_model_shards(obj, state, lambda t: gather_model(t, mesh))


def load_train_state(obj, state: dict) -> None:
    """Restore `state` into obj in place: modules strictly, the Adam states
    onto the same parameters (build obj on its device first: a card's Adam
    is the fused one), counts, generator, step, grid (a JointPipeline
    refolds its grid_folded from it) and cursor. A pipeline whose acoustic
    field is sharded over a model axis takes its shards of the field and
    of their Adam moments from the one-rank format."""
    mesh = getattr(obj, "mesh", None)
    state = map_model_shards(obj, state, lambda t: model_shard(t, mesh))
    for k, m in obj.models.items():
        m.load_state_dict(state["models"][k], strict=True)
    for k, o in obj.optimizers.items():
        o.opt.load_state_dict(state["optimizers"][k]["adam"])
        o.count = int(state["optimizers"][k]["count"])
    obj.generator.set_state(state["generator"].cpu())
    if "grid" in state:
        obj.grid = state["grid"].to(device=obj.device, dtype=torch.float32)
        obj.cursor = int(state["cursor"])
    obj.step = int(state["step"])


def checkpoint_path(ckpt_dir: str | Path, step: int) -> Path:
    return Path(ckpt_dir).absolute() / f"step-{step:09d}.pt"


def save_checkpoint(ckpt_dir: str | Path, step: int, obj,
                    keep_all: bool = True) -> Path:
    """Write obj's train state to <ckpt_dir>/step-{step:09d}.pt; without
    keep_all, delete every other step-*.pt there."""
    path = checkpoint_path(ckpt_dir, step)
    ckpt_dir = path.parent
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(train_state(obj), tmp)
    os.replace(tmp, path)
    if not keep_all:
        for p in ckpt_dir.glob("step-*.pt"):
            if p != path:
                p.unlink()
    return path


def latest_checkpoint(ckpt_dir: str | Path) -> Path | None:
    """The highest-step complete checkpoint (a crash's *.pt.tmp is not one)."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = sorted(ckpt_dir.glob("step-*.pt"))
    return steps[-1] if steps else None


def restore_checkpoint(path: str | Path, obj):
    """Load the checkpoint at path into obj (in place) -> obj."""
    load_train_state(obj, torch.load(path, map_location="cpu",
                                     weights_only=True))
    return obj
