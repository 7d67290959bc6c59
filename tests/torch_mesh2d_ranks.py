"""The rank side of tests/test_torch_mesh2d.py: what each spawned gloo rank
on the CPU runs. It imports torch and the port only (no JAX), so that a
rank starts quickly; the test module spawns `rank_main`, which runs jobs of
this module by name, one after the other, each on a (data, model) mesh of
its own shape (ranks beyond the shape's size skip the job), and rank 0
writes what the test compares into each job's output file (torch.save).
"""

from __future__ import annotations

import pickle
import traceback
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

from neraf_tpu_torch.engine.checkpoints import (
    load_train_state,
    restore_checkpoint,
    train_state,
)
from neraf_tpu_torch.fields.acoustic import AcousticSoundField
from neraf_tpu_torch.models.grid import fold_grid
from neraf_tpu_torch.parallel import sharding
from neraf_tpu_torch.parallel.sharding import (
    apply_param_shardings,
    gather_model,
    make_mesh_2d,
    replica_mismatches,
    replicated_state,
    sharded_names,
)
from torch_parallel_ranks import _arrays, _grads, _pipe


def rank_main(rank: int, world: int, init_dir: str, jobs: str,
              err: str) -> None:
    """One of `world` ranks: for each (job, (data, model), spec, out) of
    the list pickled at the path `jobs`, join a mesh of that shape at a
    file rendezvous of its own under `init_dir` (when rank < data x model)
    and run the job; a failure writes its traceback to `err`.rank<rank>
    and exits nonzero."""
    torch.set_num_threads(1)
    try:
        with open(jobs, "rb") as f:
            jobs = pickle.load(f)
        for i, (job, (data, model), spec, out) in enumerate(jobs):
            if rank >= data * model:
                continue
            mesh = make_mesh_2d(data, model, ["cpu"] * (data * model),
                                rank=rank,
                                init_method=f"file://{init_dir}/rendezvous{i}")
            try:
                result = globals()[job](mesh, spec)
                if rank == 0:
                    torch.save(result, out)
            finally:
                mesh.close()
    except BaseException:
        Path(f"{err}.rank{rank}").write_text(traceback.format_exc())
        raise


def _gathered(field, name: str, t: torch.Tensor, mesh) -> torch.Tensor:
    return gather_model(t, mesh) if name in field.placements else t


def field(mesh, spec: dict) -> dict:
    """The full-width acoustic field from spec["state"] (a path of its
    state dict), sharded with min_dim spec["min_dim"]: its output on
    spec["x"], and the gradients of the output's dot with spec["cot"]
    (the input's and every parameter's, gathered whole), the same of the
    whole field on the rank alone ("whole"), and the FLOPs of the rank's
    forward against the whole field's."""
    state = torch.load(spec["state"], weights_only=True)
    whole = AcousticSoundField(spec["in_dim"])
    whole.load_state_dict(state)
    f = AcousticSoundField(spec["in_dim"])
    f.load_state_dict(state)
    apply_param_shardings(f, mesh, spec["min_dim"])
    out, flops = {}, {}
    for name, module in (("rank", f), ("whole", whole)):
        x = torch.as_tensor(spec["x"]).requires_grad_()
        y = module(x)
        (y * torch.as_tensor(spec["cot"])).sum().backward()
        out[name] = {"out": y.detach(), "dx": x.grad,
                     "grads": {k: _gathered(module, k, p.grad, mesh)
                               for k, p in module.named_parameters()}}
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            module(x)
        flops[name] = counter.get_total_flops()
    return {**out["rank"], "whole": out["whole"],
            "placements": dict(f.placements), "flops": flops}


class _NoModelSum(torch.autograd.Function):
    """sharding._ModelInput with the backward's sum over the model axis
    dropped: each rank keeps its own columns' partial product of a sharded
    layer's input gradient (a mutation the tests must catch)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def steps(mesh, spec: dict) -> dict:
    """The tiny joint pipeline on the mesh, its field sharded with min_dim
    spec["min_dim"]; for each (checkpoint, draws) of spec["steps"] every
    rank restores the checkpoint and takes one train_step at the draws ->
    each step's record (metrics, every gradient with the field's gathered
    whole, grid, cursor, step, BatchNorm statistics, the replicas that
    differ); then the checkpoint's contents gathered from the mesh: each
    tensor's shape, and whether loading them back leaves every rank's
    state as it was, bitwise. spec["mutate"] "no_model_sum" drops the
    sharded layers' input-gradient sum over the model axis."""
    pipe = _pipe(spec, mesh)
    pipe.shard_field(spec["min_dim"])
    args = _arrays(spec["inputs"])
    kept = sharding._ModelInput
    if spec.get("mutate") == "no_model_sum":
        sharding._ModelInput = _NoModelSum
    try:
        records = []
        for path, draws in spec["steps"]:
            restore_checkpoint(path, pipe)
            metrics = pipe.train_step(*args, draws=draws)
            grads = _grads(pipe)
            field = pipe.audio_model.field
            grads.update({f"field.{k}": gather_model(p.grad, mesh)
                          for k, p in field.named_parameters()
                          if k in field.placements})
            records.append({
                "metrics": metrics, "grads": grads,
                "mismatches": replica_mismatches(
                    replicated_state(pipe), mesh, sharded_names(pipe)),
                "grid": pipe.grid.clone(), "cursor": pipe.cursor,
                "step": pipe.step,
                "folded_is_grid": pipe.grid_folded is not None and bool(
                    torch.equal(pipe.grid_folded,
                                fold_grid(pipe.grid, pipe.grid_res))),
                "stats": {k: v.clone() for k, v in
                          pipe.resnet.state_dict().items()
                          if k.endswith(("running_mean", "running_var"))}})
    finally:
        sharding._ModelInput = kept
    before = {k: v.clone() for k, v in replicated_state(pipe).items()}
    state = train_state(pipe)
    load_train_state(pipe, state)
    after = replicated_state(pipe)
    differ = torch.tensor([int(not all(torch.equal(before[k], after[k])
                                       for k in before))])
    torch.distributed.all_reduce(differ, group=mesh.world_group)
    return {"records": records,
            "placements": dict(pipe.audio_model.field.placements),
            "roundtrip_bitwise": int(differ) == 0,
            "checkpoint_shapes": _shapes(state)}


def sweeps(mesh, spec: dict) -> dict:
    """The tiny joint pipeline on the mesh, its field sharded with min_dim
    spec["min_dim"], restored from spec["checkpoint"]: evaluate_audio_device
    and evaluate_audio on spec["dataset"] at chunks of 4, and whether
    render_rirs (one rank's call) refuses the sharded field."""
    pipe = _pipe(spec, mesh)
    pipe.shard_field(spec["min_dim"])
    restore_checkpoint(spec["checkpoint"], pipe)
    ds = spec["dataset"]
    out = {"device": pipe.evaluate_audio_device(ds, chunk=4),
           "host": pipe.evaluate_audio(ds, chunk=4)}
    o = ds.outputs
    try:
        pipe.render_rirs(o.microphone_poses[:1], o.source_poses[:1],
                         o.rotations[:1])
        out["render_rirs_refused"] = False
    except RuntimeError:
        out["render_rirs_refused"] = True
    return out


def _shapes(state: dict) -> dict:
    """The shape of each tensor of a train state's models and Adam
    moments, by a flat name."""
    out = {f"{m}.{k}": tuple(v.shape) for m, sd in state["models"].items()
           for k, v in sd.items()}
    for g, entry in state["optimizers"].items():
        for i, st in entry["adam"]["state"].items():
            for k in ("exp_avg", "exp_avg_sq"):
                out[f"{g}.{i}.{k}"] = tuple(st[k].shape)
    return out
