"""The rank side of tests/test_torch_parallel.py: what each spawned gloo
rank on the CPU runs. It imports torch and the port only (no JAX), so that
a rank starts quickly; the test module spawns `rank_main`, which joins the
mesh and runs jobs of this module by name, one after the other, and rank 0
writes what the test compares into each job's output file (torch.save).
"""

from __future__ import annotations

import pickle
import traceback
import types
from pathlib import Path

import torch

from neraf_tpu_torch.data.loader import audio_arrays
from neraf_tpu_torch.data.streaming import StreamingAudioSampler
from neraf_tpu_torch.engine import pipeline as pipeline_mod
from neraf_tpu_torch.engine.checkpoints import restore_checkpoint
from neraf_tpu_torch.engine.factory import build_joint_pipeline
from neraf_tpu_torch.metrics import losses
from neraf_tpu_torch.metrics.losses import stft_loss
from neraf_tpu_torch.models.grid import fold_grid
from neraf_tpu_torch.parallel import depth_split, sharding
from neraf_tpu_torch.parallel.depth_split import local_window
from neraf_tpu_torch.parallel.sharding import (
    all_gather_batch,
    broadcast_state,
    make_mesh,
    partition,
    replica_mismatches,
    replicated_state,
)


def rank_main(rank: int, world: int, init: str, jobs: str,
              err: str) -> None:
    """One rank: join the gloo mesh at `init`, run each (job, spec, out)
    of the list pickled at the path `jobs` (a file, not an argument: the
    spawn pipe would hand the arguments to one rank after the other);
    a failure writes its traceback to `err`.rank<rank> and exits
    nonzero."""
    torch.set_num_threads(1)
    try:
        mesh = make_mesh(world, ["cpu"] * world, rank=rank, init_method=init)
        try:
            with open(jobs, "rb") as f:
                jobs = pickle.load(f)
            for job, spec, out in jobs:
                result = globals()[job](mesh, spec)
                if rank == 0:
                    torch.save(result, out)
        finally:
            mesh.close()
    except BaseException:
        Path(f"{err}.rank{rank}").write_text(traceback.format_exc())
        raise


# ------------------------------------------------------------------ helpers
def _arrays(inputs: dict):
    """Cameras, the resident split and the images as CPU tensors."""
    cams = {k: torch.as_tensor(v) for k, v in inputs["cams"].items()}
    return (cams, audio_arrays(inputs["split"], "cpu"),
            {"images": torch.as_tensor(inputs["images"])})


def _pipe(spec: dict, mesh):
    return build_joint_pipeline(grid_res=spec["grid_res"], tiny=True,
                                device="cpu", mixed_precision=False,
                                config=spec["config"], mesh=mesh)


def _load(pipe, path: str, mesh, broadcast: bool = False) -> None:
    """Every rank restores the checkpoint; with `broadcast`, rank 0 alone,
    and every rank then takes rank 0's state (as a resume does)."""
    if mesh is None or mesh.rank == 0 or not broadcast:
        restore_checkpoint(path, pipe)
    if broadcast:
        broadcast_state(pipe, mesh)


def _grads(pipe) -> dict:
    """Every parameter's gradient, named as test_torch_train_slice.py names
    them."""
    vm = pipe.vision_model
    out = {f"proposal_networks.{i}.{k}": p.grad
           for i, prop in enumerate(vm.proposal_networks)
           for k, p in prop.named_parameters()}
    out.update({f"fields.{k}": p.grad for k, p in vm.field.named_parameters()})
    out["camera_opt"] = vm.camera_opt.grad
    out.update({f"field.{k}": p.grad
                for k, p in pipe.audio_model.field.named_parameters()})
    out.update({f"resnet.{k}": p.grad
                for k, p in pipe.resnet.named_parameters()})
    return {k: v.detach().clone() for k, v in out.items()}


def _step_record(pipe, metrics: dict, mesh) -> dict:
    state = replicated_state(pipe)
    return {"metrics": metrics, "grads": _grads(pipe),
            "mismatches": replica_mismatches(state, mesh),
            "grid": pipe.grid.clone(), "cursor": pipe.cursor,
            "step": pipe.step,
            "folded_is_grid": pipe.grid_folded is not None and bool(
                torch.equal(pipe.grid_folded,
                            fold_grid(pipe.grid, pipe.grid_res))),
            "stats": {k: v.clone() for k, v in pipe.resnet.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))}}


class _GatherNoSum(torch.autograd.Function):
    """all_gather_batch (blocks of equal size) with the backward's sum over
    ranks dropped: each rank keeps its own cotangent of its block (a
    mutation the tests must catch)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
        torch.distributed.all_gather(parts, x.contiguous(), group=mesh.group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        b = grad.shape[0] // ctx.mesh.world_size
        return grad[ctx.mesh.rank * b:(ctx.mesh.rank + 1) * b], None


# --------------------------------------------------------------------- jobs
def steps(mesh, spec: dict) -> list:
    """For each (checkpoint, draws) of spec["steps"]: the state from the
    checkpoint (rank 0, then broadcast), one train_step on the global
    draws (drawn from the restored generator when None) -> each step's
    record. spec["mutate"] runs a broken variant: "sc_per_shard" takes the
    spectral convergence of each rank's block, "gather_no_sum" drops the
    bake gather's sum over ranks."""
    pipe = _pipe(spec, mesh)
    args = _arrays(spec["inputs"])
    mutate = spec.get("mutate")
    kept = losses.all_reduce_sum, pipeline_mod.all_gather_batch
    if mutate == "sc_per_shard":
        losses.all_reduce_sum = lambda x, mesh: x
    elif mutate == "gather_no_sum":
        pipeline_mod.all_gather_batch = lambda x, mesh, n: \
            _GatherNoSum.apply(x, mesh)
    try:
        out = []
        for path, draws in spec["steps"]:
            _load(pipe, path, mesh)
            metrics = pipe.train_step(*args, draws=draws)
            out.append(_step_record(pipe, metrics, mesh))
        return out
    finally:
        losses.all_reduce_sum, pipeline_mod.all_gather_batch = kept


def sweeps(mesh, spec: dict) -> dict:
    """evaluate_audio_device of the checkpoint's state on spec["dataset"]
    at each chunk of spec["chunks"], from spec["angles"] (a chunk's
    Griffin-Lim start, (max chunk, C, F, T))."""
    pipe = _pipe(spec, mesh)
    _load(pipe, spec["checkpoint"], mesh)
    ds = spec["dataset"]
    return {chunk: pipe.evaluate_audio_device(
        ds, chunk=chunk, init_angles=spec["angles"][:chunk])
        for chunk in spec["chunks"]}


def streamed(mesh, spec: dict) -> dict:
    """Two pipelines from one checkpoint, the audio branch live: one fed
    the resident split at the global draw of a StreamingAudioSampler
    without a mesh, one fed the rank's block by a sampler on the mesh
    (same seed), for spec["n_steps"] steps; then eval_loss_dict of each.
    -> the metrics of both, whether the weights, Adam moments, grid,
    folded grid and statistics are bitwise equal between them, each step's
    cross-rank mismatches, and whether the rank's streamed columns are
    its block of the global batch, bitwise."""
    res, strm = _pipe(spec, mesh), _pipe(spec, mesh)
    for p in (res, strm):
        _load(p, spec["checkpoint"], mesh, broadcast=True)
    cams, resident, images = _arrays(spec["inputs"])
    split = spec["inputs"]["split"]
    ds = types.SimpleNamespace(
        log_stft=split["log_stft"], max_len=split["log_stft"].shape[-1],
        outputs=types.SimpleNamespace(microphone_poses=split["mic_pose"],
                                      source_poses=split["source_pose"],
                                      rotations=split["rot"]))
    B = res.config.audio_data.batch_size
    H, W = images["images"].shape[1:3]
    n_rec = split["mic_pose"].shape[0]
    out = {"res": [], "str": [], "mismatches": [], "block": []}
    with StreamingAudioSampler(ds, B, seed=5, device="cpu") as whole, \
            StreamingAudioSampler(ds, B, seed=5, device="cpu",
                                  mesh=mesh) as mine:
        for _ in range(spec["n_steps"]):
            g, s = whole.next(), mine.next()
            out["block"].append(bool(torch.equal(
                sharding.shard_batch(g["data"], mesh), s["data"])))
            draws = res.draw(images["images"].shape[0], H, W, n_rec)
            strm.draw(images["images"].shape[0], H, W, n_rec)
            out["res"].append(res.train_step(cams, resident, images, draws=dict(
                draws, rec=g["audio_idx"], t=g["time_query"])))
            out["str"].append(strm.train_step(cams, s, images, draws=draws))
            out["mismatches"].append(
                replica_mismatches(replicated_state(strm), mesh))
        g, s = whole.next(), mine.next()
        out["eval_str"] = strm.eval_loss_dict(cams, s, images)
        out["eval_res"] = res.eval_loss_dict(cams, resident, images, draws=dict(
            res.eval_draws(images["images"].shape[0], H, W, n_rec),
            rec=g["audio_idx"], t=g["time_query"]))
    a, b = replicated_state(res), replicated_state(strm)
    out["same_state"] = sorted(k for k in a if not torch.equal(a[k], b[k]))
    out["same_adam"] = all(
        torch.equal(res.optimizers[n].opt.state[p][k],
                    strm.optimizers[n].opt.state[q][k])
        for n in res.optimizers
        for p, q in zip(res.optimizers[n].params, strm.optimizers[n].params)
        for k in ("exp_avg", "exp_avg_sq"))
    return out


def collectives(mesh, spec: dict) -> dict:
    """The spectral convergence and the bake gather on one global batch:
    this rank's block of the log-magnitudes through stft_loss on the mesh
    (value, and the block's gradient), the spectral convergence of the
    block alone, and the gradient of sum(w * all_gather_batch(block))."""
    x_all, y_all, w_all = (torch.as_tensor(spec[k]) for k in ("x", "y", "w"))
    x = sharding.shard_batch(x_all, mesh).clone().requires_grad_()
    y = sharding.shard_batch(y_all, mesh)
    sc = stft_loss(x, y, mesh=mesh)["audio_sc_loss"]
    sc.backward()
    shard_sc = float(stft_loss(x.detach(), y)["audio_sc_loss"])
    cells = sharding.shard_batch(w_all, mesh).clone().requires_grad_()
    (w_all * all_gather_batch(cells, mesh, w_all.shape[0])).sum().backward()
    parts = [torch.empty(1, dtype=torch.float64) for _ in range(mesh.world_size)]
    torch.distributed.all_gather(parts, torch.tensor([shard_sc],
                                                     dtype=torch.float64))
    gathered = [float(p) for p in parts]
    block_grads = [torch.empty_like(x.grad) for _ in range(mesh.world_size)]
    torch.distributed.all_gather(block_grads, x.grad)
    cell_grads = [torch.empty_like(cells.grad) for _ in range(mesh.world_size)]
    torch.distributed.all_gather(cell_grads, cells.grad)
    return {"sc": float(sc), "shard_sc": gathered,
            "sc_grad": torch.cat(block_grads),
            "cell_grad": torch.cat(cell_grads)}


# ------------------------------------------------- the depth-split ResNet
def _traces(pipe, mesh) -> list:
    """Every rank's record of its ResNet's last split forward (op, planes
    its input window held, the op's global input depth), in rank order;
    None on one rank."""
    if mesh is None:
        return None
    mine = pipe.resnet.split_trace
    out = [None] * mesh.world_size
    torch.distributed.all_gather_object(out, mine)
    return out


def features(mesh, spec: dict) -> dict:
    """The eval-mode grid feature of the checkpoint's state (the eval
    paths' _grid_feature_eval: split over the ranks under a mesh) and
    every rank's trace of its windowed ops."""
    pipe = _pipe(spec, mesh)
    _load(pipe, spec["checkpoint"], mesh)
    with pipe._eval_mode():
        feat = pipe._grid_feature_eval()
    return {"feat": feat, "traces": _traces(pipe, mesh)}


def _no_halo(x, mesh, depth, wins, fill=0.0):
    """halo_window with the exchange dropped: the window from this rank's
    own planes, every other plane set to `fill`."""
    lo, hi = wins[mesh.rank]
    b0 = partition(depth, mesh.world_size)[mesh.rank][0]
    return local_window(x, 2, lo - b0, hi - b0, fill)


def _local_stats(x, depth, mesh):
    """batch_norm_stats with the reduction dropped: this rank's slab's."""
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = x32.mean(dim=(0, 2, 3, 4))
    return mean, ((x32 - mean.view(1, -1, 1, 1, 1)) ** 2).mean(dim=(0, 2, 3, 4))


def _local_pool(x, depth, mesh):
    """global_mean_pool with the sum over ranks dropped."""
    return (x.sum(dim=(2, 3, 4))
            / float(depth * x.shape[3] * x.shape[4])).to(x.dtype)


SPLIT_MUTANTS = {"no_halo": ("halo_window", _no_halo),
                 "no_bn_reduction": ("batch_norm_stats", _local_stats),
                 "no_pool_sum": ("global_mean_pool", _local_pool)}


def split_step(mesh, spec: dict) -> dict:
    """One train_step from spec["checkpoint"] (draws from its generator),
    the stem kernel's gate as spec["gate"], on the mesh or on one rank
    (mesh None) -> the step's record, the train-mode feature and its
    cotangent, the gradient of the bake's live slab (both summed over
    ranks and divided by their number: the global batch's), every rank's
    trace of its windowed ops. spec["mutate"] names a SPLIT_MUTANTS entry
    to run; spec["feat_grad"], given, replaces the feature's cotangent
    (one rank's ResNet backward from the ranks' cotangent)."""
    pipe = _pipe(spec, mesh)
    pipe.stem_wgrad_kernel = spec["gate"]
    _load(pipe, spec["checkpoint"], mesh)
    got = {}
    kept_bake = pipeline_mod.bake_cells_folded

    def bake(*args, **kwargs):
        slab, *rest = kept_bake(*args, **kwargs)
        slab.retain_grad()
        got["slab"] = slab
        return (slab, *rest)

    def cotangent(g):
        used = spec.get("feat_grad")
        got["feat_grad"] = (g if used is None else used).clone()
        return used

    def feature(mod, args, out):
        got["feat"] = out.detach().clone()
        out.register_hook(cotangent)

    hook = pipe.resnet.register_forward_hook(feature)
    name, mutant = SPLIT_MUTANTS.get(spec.get("mutate"), (None, None))
    kept = getattr(depth_split, name) if name else None
    pipeline_mod.bake_cells_folded = bake
    if name:
        setattr(depth_split, name, mutant)
    try:
        metrics = pipe.train_step(*_arrays(spec["inputs"]))
    finally:
        pipeline_mod.bake_cells_folded = kept_bake
        hook.remove()
        if name:
            setattr(depth_split, name, kept)
    summed = {k: got[k] for k in ("feat_grad",)}
    summed["slab_grad"] = got["slab"].grad.clone()
    if mesh is not None:
        for v in summed.values():
            torch.distributed.all_reduce(v, group=mesh.group)
            v /= mesh.world_size
    return {**_step_record(pipe, metrics, mesh), "feat": got["feat"],
            **summed, "traces": _traces(pipe, mesh)}


def resnet_split(mesh, spec: dict) -> dict:
    """The ResNet alone in float64 (spec: backbone, grid, seed), its
    weights, BatchNorm statistics, a random volume and a feature cotangent
    drawn from the seed: the eval feature, then the train-mode feature,
    the BatchNorm statistics it moved and every gradient of the feature's
    dot with the cotangent (averaged over ranks as a step averages them),
    split over the mesh or whole (mesh None); every rank's traces.
    spec["mutate"] names a SPLIT_MUTANTS entry to run."""
    from neraf_tpu_torch.models.resnet3d import ResNet3D
    from neraf_tpu_torch.parallel.sharding import average_gradients

    gen = torch.Generator().manual_seed(spec["seed"])
    net = ResNet3D(spec["backbone"], 1024).double()
    net.reset_parameters(gen)
    for mod in net.modules():
        if hasattr(mod, "running_mean"):
            mod.running_mean.normal_(0.0, 0.1, generator=gen)
            mod.running_var.uniform_(0.5, 1.5, generator=gen)
    R = spec["grid"]
    vol = torch.rand((1, R, R, R, 7), generator=gen, dtype=torch.float64)
    cot = torch.randn((1, net.feature_dim), generator=gen, dtype=torch.float64)
    name, mutant = SPLIT_MUTANTS.get(spec.get("mutate"), (None, None))
    kept = getattr(depth_split, name) if name else None
    if name:
        setattr(depth_split, name, mutant)
    try:
        with torch.no_grad():
            eval_feat = net(vol, mesh=mesh)
        net.train()
        feat = net(vol, mesh=mesh)
        (feat * cot).sum().backward()
    finally:
        if name:
            setattr(depth_split, name, kept)
    average_gradients(list(net.parameters()), mesh)
    return {"eval_feat": eval_feat, "feat": feat.detach(),
            "grads": {k: p.grad.clone() for k, p in net.named_parameters()},
            "stats": {k: v.clone() for k, v in net.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))},
            "traces": None if mesh is None else _traces(
                types.SimpleNamespace(resnet=net), mesh)}
