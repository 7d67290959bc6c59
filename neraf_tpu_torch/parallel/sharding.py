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
exchanges and cross-rank BatchNorm, is parallel/depth_split.py. Its 2-D
(data, model) mesh is not ported (ROADMAP.md).
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
    """One rank's view of the data mesh: its rank, the number of ranks,
    its device and the process group."""

    rank: int
    world_size: int
    device: torch.device
    group: object = None

    def barrier(self) -> None:
        """Wait for every rank (under the group's timeout)."""
        if self.group is not None:
            # a gloo barrier is an all_reduce of a CPU tensor; NCCL's
            # barrier would guess the rank's device
            flag = torch.zeros(1, device=self._comm_device())
            dist.all_reduce(flag, group=self.group)

    def _comm_device(self) -> torch.device:
        """Where a host buffer goes for a collective: the rank's card under
        NCCL, the CPU under gloo."""
        if dist.get_backend(self.group) == "nccl":
            return self.device
        return torch.device("cpu")

    def close(self) -> None:
        """Leave the process group (every rank, at the end of a run)."""
        if self.group is not None and dist.is_initialized():
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


def gloo_needs_f32(x: torch.Tensor, mesh: DataMesh) -> bool:
    """Whether x is bfloat16 on a gloo group, which takes no bfloat16
    tensor on a card ("Invalid scalar type"): such a tensor travels as
    float32 (exactly, for a gather)."""
    return x.dtype == torch.bfloat16 and dist.get_backend(mesh.group) == "gloo"


class _AllReduceSum(torch.autograd.Function):
    """The sum over ranks; the backward sums the cotangents over ranks (as
    torch.distributed.nn.functional.all_reduce, which is deprecated). A
    bfloat16 x on gloo is summed in float32 and rounded once."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        if gloo_needs_f32(x, mesh):
            y = x.float()
            dist.all_reduce(y, group=mesh.group)
            return y.to(x.dtype)
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=mesh.group)
        return x

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
        x = x.movedim(dim, 0).to(torch.float32 if gloo_needs_f32(x, mesh)
                                 else dtype).contiguous()
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


def average_gradients(params, mesh: DataMesh | None) -> None:
    """Replace every parameter's gradient by its mean over ranks, in place
    (a missing gradient counts as zeros, as the optimizers step it). The
    gradients are flattened into buckets of up to BUCKET_BYTES of one
    dtype and all-reduced bucket by bucket, in the order of `params`,
    which every rank must give alike; a parameter listed twice is reduced
    once."""
    if mesh is None:
        return
    seen, grads = set(), []
    for p in params:
        if id(p) in seen:
            continue
        seen.add(id(p))
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    bucket, size = [], 0
    for i, g in enumerate(grads):
        bucket.append(g)
        size += g.numel() * g.element_size()
        last = i + 1 == len(grads)
        if last or size >= BUCKET_BYTES or grads[i + 1].dtype != g.dtype:
            flat = torch.cat([t.reshape(-1) for t in bucket])
            dist.all_reduce(flat, group=mesh.group)
            flat /= mesh.world_size
            offset = 0
            for t in bucket:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()
            bucket, size = [], 0


def broadcast_state(obj, mesh: DataMesh | None) -> None:
    """Load rank 0's train state into `obj` (a JointPipeline) on every
    other rank: the checkpoint's contents (engine/checkpoints.py: weights,
    BatchNorm statistics, Adam states and counts, generator, step, grid,
    cursor), serialised by torch.save on rank 0 and loaded with
    weights_only=True."""
    if mesh is None:
        return
    from neraf_tpu_torch.engine.checkpoints import load_train_state, train_state

    dev = mesh._comm_device()
    if mesh.rank == 0:
        buf = io.BytesIO()
        torch.save(train_state(obj), buf)
        payload = torch.frombuffer(bytearray(buf.getbuffer()),
                                   dtype=torch.uint8).to(dev)
        size = torch.tensor([payload.numel()], dtype=torch.int64, device=dev)
    else:
        size = torch.zeros(1, dtype=torch.int64, device=dev)
    dist.broadcast(size, 0, group=mesh.group)
    if mesh.rank != 0:
        payload = torch.empty(int(size), dtype=torch.uint8, device=dev)
    dist.broadcast(payload, 0, group=mesh.group)
    if mesh.rank != 0:
        state = torch.load(io.BytesIO(payload.cpu().numpy().tobytes()),
                           map_location="cpu", weights_only=True)
        load_train_state(obj, state)


def replica_mismatches(tensors: dict, mesh: DataMesh | None) -> list:
    """The names of the tensors (a name -> tensor dict, the same names and
    shapes on every rank) whose bytes differ from rank 0's on any rank,
    the same list on every rank, which must all call it. [] without a
    mesh."""
    if mesh is None:
        return []
    differs = []
    for t in tensors.values():
        mine = t.detach().contiguous()
        ref = mine.clone()
        dist.broadcast(ref, 0, group=mesh.group)
        differs.append(not torch.equal(ref.reshape(-1).view(torch.uint8),
                                       mine.reshape(-1).view(torch.uint8)))
    flags = torch.tensor(differs, dtype=torch.int32, device=mesh._comm_device())
    dist.all_reduce(flags, group=mesh.group)
    return [name for name, f in zip(tensors, flags.tolist()) if f]


def replicated_state(pipe) -> dict:
    """The state a JointPipeline keeps equal on every rank, by name: every
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

