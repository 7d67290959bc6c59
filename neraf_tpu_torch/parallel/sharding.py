"""The 1-D data mesh of neraf_tpu/parallel/sharding.py as torch.distributed
ranks: one process a rank, one device a rank.

The JAX package trains on a mesh with one axis, "data": ray batches,
STFT-slice batches, grid-bake cells and the eval RIR sweep are sharded on
their leading axis, while parameters, the grid and the optimizer states are
replicated; XLA inserts the gradient reductions. Here every rank is a
process of its own that holds the replicated state and computes its
contiguous block of each batch (`shard_batch`, what P("data") gives a
device). A length n is split as XLA tiles P("data") (`partition`): blocks
of ceil(n / N) in rank order, the last ones shorter (or empty), so a batch
need not divide by the number of ranks. The collectives are explicit:

- `all_reduce_sum`, `global_mean` and `all_gather_batch` are
  differentiable; the backward of each sums the cotangents of every rank,
  so a loss that every rank computes on global sums (metrics/losses.py
  under a mesh) and cells that every rank gathers (the grid bake) give
  each rank its part of the global-batch gradient, times the number of
  ranks;
- `average_gradients` all-reduces the flattened gradients in buckets and
  divides by the number of ranks, which turns those parts into the
  gradient of the global batch, the same on every rank (so the parameters
  stay bitwise equal across ranks);
- `broadcast_state` sends rank 0's train state (weights, BatchNorm
  statistics, Adam state, grid, cursor, step, generator) to the others, at
  the start of a run and after a resume, in the checkpoint format.

NCCL carries the collectives when every rank has a card of its own, gloo on
the CPU. Gloo also takes card tensors (all_reduce, all_gather, broadcast):
two ranks on one card, which NCCL refuses, need `backend="gloo"` given
explicitly. Every collective runs under the process group's timeout, so a
rank that died fails the others instead of hanging them.

The JAX package's depth split of the ResNet over the mesh, with its halo
exchanges and cross-rank BatchNorm, is parallel/depth_split.py.

The 2-D (data, model) mesh (make_mesh_2d, the JAX package's
sharding.py:41-85): data x model ranks, the model axis innermost (rank r
is (r // model, r % model), JAX's device d * model + m). A DataMesh's
`rank`, `world_size` and `group` stay the DATA axis (its column: the ranks
with its model index), so that everything above computes on a 2-D mesh
what the JAX rule computes on "data": batches, bake cells, sweeps and the
ResNet's depth split go over the data axis and are replicated over the
model axis. `model_rank`, `model_size` and `model_group` are the model
axis (its row: the ranks with its data index); make_mesh's mesh is the
(n, 1) one. param_shardings / apply_param_shardings column-shard the
acoustic field's wide layers over the model axis as the JAX rule does
(fields/acoustic.py): each such layer computes its slice of the outputs
and all-gathers the slices (`sharded_linear`), its input gradient summed
over the model axis. Each shard's gradient is averaged over its data
column, every replicated gradient over all ranks (`average_gradients`), a
checkpoint holds the gathered field (the one-rank format), and
`replica_mismatches` checks the replicated tensors over every rank and
each shard over its data column.

A trap on subgroups: torch.distributed's `src` is a rank of the default
group, so a broadcast in a column whose first member is not rank 0 names
that member (`model_rank`), never 0.
"""

from __future__ import annotations

import dataclasses
import datetime
import io
import os

import torch
import torch.distributed as dist

# a collective that waits longer than this fails the run (a dead rank)
TIMEOUT = datetime.timedelta(minutes=5)
# average_gradients' all_reduce bucket
BUCKET_BYTES = 64 * 2**20


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """One rank's view of the mesh: its index on the data axis (`rank`),
    the data axis's size (`world_size`), its device and the data axis's
    process group (`group`: the ranks with its model index); on a 2-D
    mesh also its index on the model axis, that axis's size and its
    process group (the ranks with its data index). The 1-D mesh is the
    (n, 1) one, its model axis a rank alone."""

    rank: int
    world_size: int
    device: torch.device
    group: object = None
    model_rank: int = 0
    model_size: int = 1
    model_group: object = None
    axis_names: tuple = ("data",)

    @property
    def global_rank(self) -> int:
        """The rank in the default group: data index * model size + model
        index."""
        return self.rank * self.model_size + self.model_rank

    @property
    def world_group(self):
        """The group of every rank."""
        return self.group if self.model_size == 1 else dist.group.WORLD

    def barrier(self) -> None:
        """Wait for every rank (under the group's timeout)."""
        if self.group is not None:
            # a gloo barrier is an all_reduce of a CPU tensor; NCCL's
            # barrier would guess the rank's device
            flag = torch.zeros(1, device=self._comm_device())
            dist.all_reduce(flag, group=self.world_group)

    def _comm_device(self) -> torch.device:
        """Where a host buffer goes for a collective: the rank's card under
        NCCL, the CPU under gloo."""
        if dist.get_backend(self.group) == "nccl":
            return self.device
        return torch.device("cpu")

    def close(self) -> None:
        """Leave the process groups, the axes' subgroups first (every rank,
        at the end of a run)."""
        if self.group is not None and dist.is_initialized():
            if self.model_size > 1:
                for g in (self.group, self.model_group):
                    dist.destroy_process_group(g)
            dist.destroy_process_group()


def _normalise(device) -> torch.device:
    d = torch.device(device)
    return torch.device("cuda", d.index or 0) if d.type == "cuda" else d


def make_mesh(num_devices: int | None = None, devices=None,
              backend: str | None = None, *, rank: int | None = None,
              init_method: str = "env://") -> DataMesh:
    """Join the data mesh as `rank` (default: the RANK environment
    variable) of `num_devices` ranks, the first num_devices of `devices`
    (default: every card, "cuda:0", "cuda:1", ...; all of them when
    num_devices is None), rank i on devices[i]. Every rank calls this with
    the same arguments but its rank; `init_method` is torch.distributed's
    rendezvous (env://, tcp://host:port, file://path).

    backend None takes NCCL when every rank has a card of its own and gloo
    when every rank is on the CPU; a card shared by ranks needs
    backend="gloo" given. Raises ValueError for fewer devices than ranks,
    as the JAX package's make_mesh does, for a rank out of range, and for
    a shared card or mixed devices without an explicit backend."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [_normalise(d) for d in devices]
    if num_devices is None:
        num_devices = len(devices)
    if len(devices) < num_devices:
        raise ValueError(f"requested {num_devices} devices, have "
                         f"{len(devices)}")
    devices = devices[:num_devices]
    if rank is None:
        rank = int(os.environ["RANK"])
    if not 0 <= rank < num_devices:
        raise ValueError(f"rank {rank} of {num_devices} ranks")
    kinds = {d.type for d in devices}
    if backend is None:
        if kinds == {"cpu"}:
            backend = "gloo"
        elif kinds == {"cuda"} and len(set(devices)) == len(devices):
            backend = "nccl"
        else:
            raise ValueError(
                f"devices {[str(d) for d in devices]}: a card shared by "
                f"ranks or mixed devices need backend='gloo' given")
    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_devices, rank=rank,
                            timeout=TIMEOUT)
    return DataMesh(rank, num_devices, device, dist.group.WORLD)


def make_mesh_2d(data: int, model: int, devices=None,
                 backend: str | None = None, *, rank: int | None = None,
                 init_method: str = "env://") -> DataMesh:
    """Join the (data, model) mesh of data x model ranks as `rank`, the
    model axis innermost as in the JAX package's layout: rank r is (r //
    model, r % model), on devices[r] (make_mesh's arguments, which it
    raises on as make_mesh does). Every rank then makes every data column
    (the ranks with one model index) and every model row (the ranks with
    one data index) in the same order, as torch.distributed's new_group
    needs, and keeps its own."""
    base = make_mesh(data * model, devices, backend, rank=rank,
                     init_method=init_method)
    r = base.rank
    columns = [dist.new_group([d * model + m for d in range(data)],
                              timeout=TIMEOUT) for m in range(model)]
    rows = [dist.new_group([d * model + m for m in range(model)],
                           timeout=TIMEOUT) for d in range(data)]
    return DataMesh(r // model, data, base.device, columns[r % model],
                    r % model, model, rows[r // model], ("data", "model"))


def mesh_axis(mesh: DataMesh | None, name: str) -> bool:
    """Whether the mesh has the axis `name` (a make_mesh mesh has "data",
    a make_mesh_2d mesh "data" and "model")."""
    return mesh is not None and name in mesh.axis_names


def partition(n: int, world: int) -> list:
    """[(lo, hi)] of each rank's block of a length n over `world` ranks, as
    XLA tiles P("data"): blocks of ceil(n / world) in rank order, the last
    ones shorter or empty."""
    b = -(-n // world)
    return [(min(r * b, n), min((r + 1) * b, n)) for r in range(world)]


def block_range(n: int, mesh: DataMesh | None) -> tuple:
    """(lo, hi) of this rank's block of a length n; (0, n) without a
    mesh."""
    return (0, n) if mesh is None else partition(n, mesh.world_size)[mesh.rank]


def _block(x, mesh: DataMesh):
    lo, hi = block_range(x.shape[0], mesh)
    return x[lo:hi]


def shard_batch(tree, mesh: DataMesh | None):
    """This rank's contiguous block of the leading axis of every tensor or
    array in `tree` (a dict, list or tuple of them, or one), as P("data")
    shards it (`partition`: a leading axis that does not divide by the
    number of ranks gives shorter last blocks); the tree itself without a
    mesh."""
    if mesh is None:
        return tree
    if isinstance(tree, dict):
        return {k: shard_batch(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(v, mesh) for v in tree)
    return _block(tree, mesh)


def gloo_needs_f32(x: torch.Tensor, group) -> bool:
    """Whether x is bfloat16 on a gloo group, which takes no bfloat16
    tensor on a card ("Invalid scalar type"): such a tensor travels as
    float32 (exactly, for a gather)."""
    return x.dtype == torch.bfloat16 and dist.get_backend(group) == "gloo"


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    """A new tensor, the sum of x over `group`; a bfloat16 x on gloo is
    summed in float32 and rounded once."""
    if gloo_needs_f32(x, group):
        y = x.float()
        dist.all_reduce(y, group=group)
        return y.to(x.dtype)
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, group=group)
    return x


class _AllReduceSum(torch.autograd.Function):
    """The sum over ranks; the backward sums the cotangents over ranks (as
    torch.distributed.nn.functional.all_reduce, which is deprecated). A
    bfloat16 x on gloo is summed in float32 and rounded once."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _summed(x, mesh.group)

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.mesh), None


def all_reduce_sum(x: torch.Tensor, mesh: DataMesh | None) -> torch.Tensor:
    """The sum of x over ranks, on every rank; differentiable (the backward
    sums the cotangents over ranks). x itself without a mesh."""
    return x if mesh is None else _AllReduceSum.apply(x, mesh)


def global_mean(x: torch.Tensor, mesh: DataMesh | None,
                count: int) -> torch.Tensor:
    """The global-batch mean from x, this rank's mean over the `count`
    items of its block (a rank with none may pass anything): the mean over
    every rank's items, sum(count_r x_r) / sum(count_r), on every rank;
    differentiable. x itself without a mesh."""
    if mesh is None:
        return x
    # an empty block's mean is NaN; it stays in the graph, as every rank's
    # must for the collective's backward
    part = (x if count else x.nan_to_num(0.0)) * count
    n = torch.full((1,), float(count), dtype=x.dtype, device=x.device)
    s = all_reduce_sum(torch.cat([part.reshape(-1), n]), mesh)
    return (s[:-1] / s[-1]).reshape(x.shape)


class _AllGatherBlocks(torch.autograd.Function):
    """Concatenate every rank's block along `dim`, blocks of the given
    sizes in rank order (padded to the largest for the collective, then
    trimmed); the backward sums the cotangents of every rank and returns
    this rank's block (an all_reduce, which gloo also runs on card
    tensors, where it has no reduce_scatter)."""

    @staticmethod
    def forward(ctx, x, mesh, sizes, dim):
        ctx.mesh, ctx.sizes, ctx.dim = mesh, sizes, dim
        dtype = x.dtype
        x = x.movedim(dim, 0).to(
            torch.float32 if gloo_needs_f32(x, mesh.group) else dtype
        ).contiguous()
        m = max(sizes)
        if x.shape[0] < m:
            x = torch.cat([x, x.new_zeros((m - x.shape[0], *x.shape[1:]))])
        parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
        dist.all_gather(parts, x, group=mesh.group)
        out = torch.cat([p[:k] for p, k in zip(parts, sizes)])
        return out.movedim(0, dim).to(dtype).contiguous()

    @staticmethod
    def backward(ctx, grad):
        lo = sum(ctx.sizes[:ctx.mesh.rank])
        total = _AllReduceSum.apply(grad, ctx.mesh)
        return (total.narrow(ctx.dim, lo, ctx.sizes[ctx.mesh.rank]), None,
                None, None)


def all_gather_batch(x: torch.Tensor, mesh: DataMesh | None, n: int,
                     dim: int = 0) -> torch.Tensor:
    """Every rank's block along `dim` of a length n, as partition(n) splits
    it -> the whole (n along dim) in rank order, on every rank;
    differentiable (the backward sums over ranks and returns this rank's
    block). x itself without a mesh."""
    if mesh is None:
        return x
    sizes = [hi - lo for lo, hi in partition(n, mesh.world_size)]
    return _AllGatherBlocks.apply(x, mesh, sizes, dim)


def average_gradients(params, mesh: DataMesh | None,
                      sharded=frozenset()) -> None:
    """Replace every parameter's gradient by its mean over ranks, in place
    (a missing gradient counts as zeros, as the optimizers step it): a
    model-sharded parameter's (its id in `sharded`) over its data column,
    every other one over all ranks. The gradients are flattened into
    buckets of up to BUCKET_BYTES of one dtype and all-reduced bucket by
    bucket, the replicated ones first, in the order of `params`, which
    every rank must give alike; a parameter listed twice is reduced once.

    On a 2-D mesh a model row's ranks compute a replicated parameter's
    gradient from the same inputs, but not always to the same bits (the
    hash backward's atomics, some cuDNN weight-gradient algorithms): the
    sum over all ranks divided by their number is the data mean, and one
    all_reduce leaves the same bits on every rank, so the replicas stay
    equal by construction."""
    if mesh is None:
        return
    seen, every, column = set(), [], []
    for p in params:
        if id(p) in seen:
            continue
        seen.add(id(p))
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        (column if id(p) in sharded else every).append(p.grad)
    _average(every, mesh.world_group, mesh.world_size * mesh.model_size)
    _average(column, mesh.group, mesh.world_size)


def _average(grads: list, group, n: int) -> None:
    """Each of `grads` replaced by its mean over the n ranks of `group`,
    in buckets (average_gradients)."""
    bucket, size = [], 0
    for i, g in enumerate(grads):
        bucket.append(g)
        size += g.numel() * g.element_size()
        last = i + 1 == len(grads)
        if last or size >= BUCKET_BYTES or grads[i + 1].dtype != g.dtype:
            flat = torch.cat([t.reshape(-1) for t in bucket])
            dist.all_reduce(flat, group=group)
            flat /= n
            offset = 0
            for t in bucket:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()
            bucket, size = [], 0


def broadcast_state(obj, mesh: DataMesh | None, state: dict | None = None
                    ) -> None:
    """Load rank 0's train state into `obj` (a JointPipeline) on every
    rank, all of which call it: the checkpoint's contents
    (engine/checkpoints.py: weights, BatchNorm statistics, Adam states and
    counts, generator, step, grid, cursor), serialised by torch.save on
    rank 0 and loaded with weights_only=True. That state is `state` when
    rank 0 gives one (the one-rank format, e.g. another pipeline's
    train_state; every rank, rank 0 too, loads a copy of it), else rank
    0's own. Sent before the field is model-sharded, it is whole; from a
    sharded field rank 0's own state is its model row's gathered shards
    (so every rank then takes part in train_state's gather), and a load
    slices each rank's shard out of it. A resume into a sharded field
    passes the restored state as `state`: the other ranks of rank 0's row
    hold their shards of the state before."""
    if mesh is None:
        return
    from neraf_tpu_torch.engine.checkpoints import load_train_state, train_state

    dev = mesh._comm_device()
    group = mesh.world_group
    # whether rank 0 gave a state, on every rank
    given = torch.tensor([int(state is not None)], device=dev)
    dist.broadcast(given, 0, group=group)
    given = bool(given)
    if not given and field_placements(obj):
        state = train_state(obj)  # every rank: a gather over its model row
    if mesh.global_rank == 0:
        buf = io.BytesIO()
        torch.save(train_state(obj) if state is None else state, buf)
        payload = torch.frombuffer(bytearray(buf.getbuffer()),
                                   dtype=torch.uint8).to(dev)
        size = torch.tensor([payload.numel()], dtype=torch.int64, device=dev)
    else:
        size = torch.zeros(1, dtype=torch.int64, device=dev)
    dist.broadcast(size, 0, group=group)
    if mesh.global_rank != 0:
        payload = torch.empty(int(size), dtype=torch.uint8, device=dev)
    dist.broadcast(payload, 0, group=group)
    if mesh.global_rank != 0 or given:
        load_train_state(obj, torch.load(
            io.BytesIO(payload.cpu().numpy().tobytes()), map_location="cpu",
            weights_only=True))


def replica_mismatches(tensors: dict, mesh: DataMesh | None,
                       sharded=()) -> list:
    """The names of the tensors (a name -> tensor dict, the same names and
    shapes on every rank) whose bytes differ from the first rank's that
    holds the same tensor: rank 0 for a replicated one, the first rank of
    its data column for a model shard (its name in `sharded`); the same
    list on every rank, which must all call it. [] without a mesh."""
    if mesh is None:
        return []
    differs = []
    for name, t in tensors.items():
        # src is a rank of the default group: the column's first member,
        # (0, model_rank), is rank model_rank
        group, src = ((mesh.group, mesh.model_rank) if name in sharded
                      else (mesh.world_group, 0))
        mine = t.detach().contiguous()
        ref = mine.clone()
        dist.broadcast(ref, src, group=group)
        differs.append(not torch.equal(ref.reshape(-1).view(torch.uint8),
                                       mine.reshape(-1).view(torch.uint8)))
    flags = torch.tensor(differs, dtype=torch.int32, device=mesh._comm_device())
    dist.all_reduce(flags, group=mesh.world_group)
    return [name for name, f in zip(tensors, flags.tolist()) if f]


def replicated_state(pipe) -> dict:
    """The state a JointPipeline keeps equal on every rank (each model
    shard on every rank of its data column: sharded_names), by name: every
    parameter and buffer (BatchNorm statistics), the grid, the folded grid
    and the cursor and step."""
    out = {f"{m}.{k}": v for m, mod in pipe.models.items()
           for k, v in mod.state_dict().items()}
    out["grid"] = pipe.grid
    if pipe.grid_folded is not None:
        out["grid_folded"] = pipe.grid_folded
    out["cursor_step"] = torch.tensor([pipe.cursor, pipe.step],
                                      dtype=torch.int64, device=pipe.device)
    return out


def sharded_names(pipe) -> set:
    """The names in replicated_state of the pipeline's model shards."""
    return {f"audio_model.{k}" for k in field_placements(pipe)}


# --------------------------------------------------------------- model axis
# The JAX package's param_shardings (neraf_tpu/parallel/sharding.py:57-78)
# on the acoustic field: a 2-D kernel with >= min_dim outputs is P(None,
# "model"), a 1-D bias with >= min_dim entries P("model"), every other leaf
# replicated. flax's kernel is (in, out) and its rule reads shape[-1], the
# outputs; torch's nn.Linear weight is (out, in), so its rows are split.
# A spec names the axis of each tensor dimension, as a PartitionSpec does.


def param_shardings(field, mesh: DataMesh | None, min_dim: int = 1024) -> dict:
    """{parameter name: spec} of a module's parameters under the JAX rule:
    ("model", None) for a weight with >= min_dim rows (outputs), ("model",)
    for a bias with >= min_dim entries, () for every other one and for
    every one on a mesh without a model axis."""
    def spec(p):
        if not mesh_axis(mesh, "model") or p.shape[0] < min_dim:
            return ()
        return {2: ("model", None), 1: ("model",)}.get(p.ndim, ())

    return {name: spec(p) for name, p in field.named_parameters()}


def model_shard(x: torch.Tensor, mesh: DataMesh, dim: int = 0) -> torch.Tensor:
    """This rank's block of x along `dim` over the model axis (blocks in
    model order, as jax.device_put places P("model")); ValueError when the
    axis does not divide the dimension, as JAX raises."""
    n, m = x.shape[dim], mesh.model_size
    if n % m:
        raise ValueError(f"a dimension of {n} does not divide over a model "
                         f"axis of {m}")
    return x.narrow(dim, mesh.model_rank * (n // m), n // m).clone()


def apply_param_shardings(field, mesh: DataMesh, min_dim: int = 1024):
    """Turn a whole field (fields/acoustic.py::AcousticSoundField) into
    this rank's shard, in place: each parameter param_shardings splits
    keeps its block of rows (model_shard; the same Parameter objects, so
    an optimizer built on them steps the shards), and the field records
    its mesh and `placements` ({name: spec} of the split ones), which its
    forward reads. Raises ValueError for a width the model axis does not
    divide (the field is left whole) -> the field."""
    if field.placements:
        raise ValueError("the field is sharded already")
    specs = {k: v for k, v in param_shardings(field, mesh, min_dim).items()
             if v}
    params = dict(field.named_parameters())
    shards = {k: model_shard(params[k].data, mesh) for k in specs}
    for k, t in shards.items():
        params[k].data = t
    field.mesh, field.placements = mesh, specs
    return field


def field_placements(obj) -> dict:
    """{name in obj.audio_model's state_dict: spec} of a pipeline's
    model-sharded field parameters; {} when it has none."""
    field = getattr(getattr(obj, "audio_model", None), "field", None)
    return {f"field.{k}": v for k, v in
            getattr(field, "placements", {}).items()}


def sharded_params(obj) -> set:
    """The ids of a pipeline's model-sharded parameters."""
    names = field_placements(obj)
    return {id(p) for k, p in obj.audio_model.named_parameters()
            if k in names}


def gather_model(x: torch.Tensor, mesh: DataMesh, dim: int = 0) -> torch.Tensor:
    """The model row's blocks of x along `dim` (model_shard's), whole, in
    model order, on every rank of the row (not differentiable)."""
    dtype = x.dtype
    y = x.detach().movedim(dim, 0).to(
        torch.float32 if gloo_needs_f32(x, mesh.model_group) else dtype
    ).contiguous()
    parts = [torch.empty_like(y) for _ in range(mesh.model_size)]
    dist.all_gather(parts, y, group=mesh.model_group)
    return torch.cat(parts).to(dtype).movedim(0, dim).contiguous()


def map_model_shards(obj, state: dict, fn) -> dict:
    """A train state (engine/checkpoints.py's layout) with fn applied to
    each of obj's model-sharded tensors in it: the field's split
    parameters and their Adam moments, in the same order on every rank;
    `state` itself when obj has none (its dicts are copied, not
    changed)."""
    names = field_placements(obj)
    if not names:
        return state
    ids = sharded_params(obj)
    models = dict(state["models"])
    models["audio_model"] = {k: fn(v) if k in names else v
                             for k, v in models["audio_model"].items()}
    opts = {}
    for key, o in obj.optimizers.items():
        entry = state["optimizers"][key]
        adam = dict(entry["adam"])
        adam["state"] = {i: {k: fn(v) if k in ("exp_avg", "exp_avg_sq") else v
                             for k, v in st.items()}
                         if id(o.params[i]) in ids else st
                         for i, st in adam["state"].items()}
        opts[key] = {**entry, "adam": adam}
    return {**state, "models": models, "optimizers": opts}


class _ModelInput(torch.autograd.Function):
    """A sharded layer's input: the identity; the backward sums the
    cotangent over the model axis (each model rank's is the partial product
    of its columns, whose sum XLA inserts)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.mesh.model_group), None


class _GatherColumns(torch.autograd.Function):
    """Every model rank's columns of a sharded layer's output (..., n / M),
    concatenated in model order (..., n); the backward gives each rank its
    columns of the cotangent, which every model rank holds whole (the
    layers after it are replicated over the model axis)."""

    @staticmethod
    def forward(ctx, y, mesh):
        ctx.mesh, ctx.width = mesh, y.shape[-1]
        return gather_model(y, mesh, dim=y.ndim - 1)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.mesh.model_rank * ctx.width
        return grad.narrow(-1, lo, ctx.width).contiguous(), None


def sharded_linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   mesh: DataMesh) -> torch.Tensor:
    """A column-sharded Linear layer: this rank's block of the output
    columns, F.linear (cuBLAS on a card, as the JAX package's XLA dot)
    with its rows of the weight and bias, then every rank's gathered ->
    the whole (..., out) activation on every rank of the model row;
    differentiable."""
    y = torch.nn.functional.linear(_ModelInput.apply(x, mesh), weight, bias)
    return _GatherColumns.apply(y, mesh)
