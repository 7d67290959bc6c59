"""The JAX package's depth split of the ResNet over the data mesh
(neraf_tpu/engine/pipeline.py:238-281, the `reshard` hook that
models/resnet3d.py applies at the stem's input and at every stage
boundary), as explicit collectives between torch.distributed ranks.

Under its mesh the JAX package shards the (1, D, H, W, C) grid volume on
depth over the "data" axis while every windowed op of the next stage keeps
at least two planes a shard (`splits`: depth >= 2 x next stride x ranks),
and replicates it below that; GSPMD then inserts the conv halo exchanges,
the cross-device BatchNorm statistics and the sum of the final average
pool. Here a split activation (1, C, d, H, W) holds this rank's block of
the global depth D, the planes partition(D) gives it (parallel/sharding.py:
ceil-sized blocks in rank order, as XLA tiles P("data")), and:

- a windowed op (kernel k, stride s, padding p along depth) computes the
  rank's block of its OUTPUT planes, partition(D_out), from a window of
  input planes that `halo_window` assembles: the rank's own planes, the
  neighbours' planes its output reads (one all_gather of the planes some
  other rank reads), and the op's own padding beyond the global edge
  (zeros for a conv, -inf for the max pool); the op then runs with no
  depth padding. Global plane indices keep a stride's parity wherever a
  block starts. Its backward sends each halo plane's cotangent back to
  its owner, which adds it (one all_reduce of the halo planes);
- train-mode BatchNorm (`batch_norm_stats`) normalises with the global
  mean and biased variance: each rank's (mean, sum of squared deviations)
  in float32, gathered, merged in rank order with the blocks' counts
  (Chan's merge: no E[x^2] - E[x]^2 cancellation on a near-constant
  volume), the same bits on every rank, so the running statistics stay
  replicated;
- the average pool (`global_mean_pool`) is the all-reduced sum of every
  rank's slab over the global voxel count;
- `DepthSplit.reshard` gathers the slabs (all_gather_batch along depth)
  once the rule replicates, and a whole stage then runs on every rank.

Every collective is differentiable and sums the cotangents of every rank
in its backward, as parallel/sharding.py's do: each rank's gradient of a
ResNet weight is N times its slab's share of the global-batch gradient,
which average_gradients divides by N. A rank whose block of some output
is empty still runs the op on one dummy plane and drops it, so that every
rank makes the same collectives in the same order.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist
import torch.nn.functional as F

from neraf_tpu_torch.parallel.sharding import (
    DataMesh,
    all_gather_batch,
    all_reduce_sum,
    gloo_needs_f32,
    partition,
)


def splits(depth: int, next_stride: int, world: int) -> bool:
    """The JAX reshard rule (neraf_tpu/engine/pipeline.py:256-269): split
    a volume of `depth` planes over `world` ranks while every windowed op
    of the next stage keeps at least 2 planes a shard."""
    return world > 1 and depth >= 2 * next_stride * world


def out_depth(depth: int, k: int, s: int, p: int) -> int:
    return (depth + 2 * p - k) // s + 1


@functools.lru_cache(maxsize=None)
def windows(depth: int, k: int, s: int, p: int, world: int) -> tuple:
    """Each rank's window [lo, hi) of input planes (global indices, those
    outside [0, depth) being padding) for its block of the output planes
    of an op of kernel k, stride s and padding p; an empty block of
    output planes takes one plane's window (computed, then dropped)."""
    out = []
    for o0, o1 in partition(out_depth(depth, k, s, p), world):
        lo = o0 * s - p
        out.append((lo, lo + (max(o1 - o0, 1) - 1) * s + k))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _plan(depth: int, wins: tuple, world: int) -> tuple:
    """(blocks, sends): sends[q] the sorted planes of rank q's block that
    some other rank's window reads."""
    blocks = partition(depth, world)
    sends = []
    for q, (b0, b1) in enumerate(blocks):
        need = set()
        for r, (lo, hi) in enumerate(wins):
            if r != q:
                need.update(range(max(lo, b0), min(hi, b1)))
        sends.append(tuple(sorted(need)))
    return blocks, tuple(sends)


@functools.lru_cache(maxsize=None)
def _runs(depth: int, wins: tuple, world: int, rank: int) -> tuple:
    """This rank's window as runs (source, first index, planes): source -1
    the padding, this rank its own planes (indices into its block), another
    rank that rank's sent planes (indices into its sends)."""
    blocks, sends = _plan(depth, wins, world)
    b = -(-depth // world)
    lo, hi = wins[rank]
    runs = []
    for p in range(lo, hi):
        if not 0 <= p < depth:
            src, i = -1, 0
        else:
            src = p // b
            i = p - blocks[src][0] if src == rank else sends[src].index(p)
        last = runs[-1] if runs else None
        if last and last[0] == src and (src == -1 or last[1] + last[2] == i):
            last[2] += 1
        else:
            runs.append([src, i, 1])
    return tuple(tuple(r) for r in runs)


class _HaloWindow(torch.autograd.Function):
    """(x, this rank's block of a depth-split (1, C, d, H, W) activation of
    global depth `depth`) -> its window wins[rank] (every rank's window
    given), the padding planes set to `fill`."""

    @staticmethod
    def forward(ctx, x, mesh, depth, wins, fill):
        world, rank = mesh.world_size, mesh.rank
        blocks, sends = _plan(depth, wins, world)
        ctx.mesh, ctx.depth, ctx.wins, ctx.shape = mesh, depth, wins, x.shape
        parts = None
        if any(sends):
            m = max(len(s) for s in sends)
            b0 = blocks[rank][0]
            mine = x.new_zeros((*x.shape[:2], m, *x.shape[3:]))
            if sends[rank]:
                mine[:, :, :len(sends[rank])] = x[:, :, [p - b0 for p in sends[rank]]]
            if gloo_needs_f32(mine, mesh):
                mine = mine.float()  # exact, and back
            parts = [torch.empty_like(mine) for _ in range(world)]
            dist.all_gather(parts, mine, group=mesh.group)
            parts = [p.to(x.dtype) for p in parts]
        pieces = []
        for src, i, n in _runs(depth, wins, world, rank):
            if src == -1:
                pieces.append(x.new_full((*x.shape[:2], n, *x.shape[3:]), fill))
            elif src == rank:
                pieces.append(x[:, :, i:i + n])
            else:
                pieces.append(parts[src][:, :, i:i + n])
        return torch.cat(pieces, dim=2)

    @staticmethod
    def backward(ctx, g):
        mesh, depth, wins = ctx.mesh, ctx.depth, ctx.wins
        world, rank = mesh.world_size, mesh.rank
        blocks, sends = _plan(depth, wins, world)
        b0, b1 = blocks[rank]
        lo, hi = wins[rank]
        dx = g.new_zeros(ctx.shape)
        a, b = max(lo, b0), min(hi, b1)
        if a < b:
            dx[:, :, a - b0:b - b0] = g[:, :, a - lo:b - lo]
        if any(sends):
            # one slot a rank, its sent planes in order: this rank fills the
            # other ranks' slots with the cotangents of the planes it read
            offs = [0]
            for s in sends:
                offs.append(offs[-1] + len(s))
            buf = g.new_zeros((*g.shape[:2], offs[-1], *g.shape[3:]),
                              dtype=torch.float32)
            for q, s in enumerate(sends):
                if q == rank:
                    continue
                for j, p in enumerate(s):
                    if lo <= p < hi:
                        buf[:, :, offs[q] + j] = g[:, :, p - lo]
            dist.all_reduce(buf, group=mesh.group)
            own = sends[rank]
            if own:
                idx = [p - b0 for p in own]
                dx[:, :, idx] += buf[:, :, offs[rank]:offs[rank + 1]].to(dx.dtype)
        return dx, None, None, None, None


def halo_window(x: torch.Tensor, mesh: DataMesh, depth: int, wins: tuple,
                fill: float = 0.0) -> torch.Tensor:
    """This rank's window wins[mesh.rank] of a depth-split activation x
    (its block of `depth` planes), the neighbours' planes exchanged and
    the planes beyond the global edge set to `fill`; differentiable (the
    halo planes' cotangents go back to their owners). x itself when the
    window is x's own block."""
    lo, hi = wins[mesh.rank]
    b0, b1 = partition(depth, mesh.world_size)[mesh.rank]
    if (lo, hi) == (b0, b1) and not any(_plan(depth, wins, mesh.world_size)[1]):
        return x
    return _HaloWindow.apply(x, mesh, depth, wins, fill)


def local_window(vol: torch.Tensor, dim: int, lo: int, hi: int,
                 fill: float = 0.0) -> torch.Tensor:
    """Planes [lo, hi) along `dim` of a volume every rank holds whole, the
    planes outside it set to `fill`; differentiable."""
    n = vol.shape[dim]
    a, b = max(lo, 0), min(hi, n)
    before = min(max(-lo, 0), hi - lo)
    core = max(b - a, 0)
    after = hi - lo - before - core
    shape = list(vol.shape)
    parts = []
    if before:
        shape[dim] = before
        parts.append(vol.new_full(shape, fill))
    if core:
        parts.append(vol.narrow(dim, a, core))
    if after:
        shape[dim] = after
        parts.append(vol.new_full(shape, fill))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def batch_norm_stats(x: torch.Tensor, depth: int,
                     mesh: DataMesh) -> tuple:
    """The global (mean, biased variance) per channel, in float32 (float64
    for a float64 x), of a depth-split (1, C, d, H, W) activation of
    `depth` planes: each rank's (mean, sum of squared deviations) gathered
    and merged in rank order with the blocks' counts; differentiable."""
    hw = x.shape[3] * x.shape[4]
    counts = [(hi - lo) * hw for lo, hi in partition(depth, mesh.world_size)]
    n = counts[mesh.rank]
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = x32.sum(dim=(0, 2, 3, 4)) / max(n, 1)
    m2 = ((x32 - mean.view(1, -1, 1, 1, 1)) ** 2).sum(dim=(0, 2, 3, 4))
    both = all_gather_batch(torch.stack([mean, m2])[None], mesh,
                            n=mesh.world_size)  # (N, 2, C)
    w = torch.tensor(counts, dtype=x32.dtype, device=x.device)[:, None]
    total = float(sum(counts))
    g_mean = (w * both[:, 0]).sum(0) / total
    g_m2 = both[:, 1].sum(0) + (w * (both[:, 0] - g_mean) ** 2).sum(0)
    return g_mean, g_m2 / total


def global_mean_pool(x: torch.Tensor, depth: int,
                     mesh: DataMesh) -> torch.Tensor:
    """(1, C) mean over the global volume of a depth-split (1, C, d, H, W)
    activation: the all-reduced sum of the ranks' slabs (float32, float64
    for a float64 x) over the global voxel count, in x's type as the whole
    volume's mean is."""
    acc = torch.promote_types(x.dtype, torch.float32)
    s = all_reduce_sum(x.to(acc).sum(dim=(2, 3, 4)), mesh)
    return (s / float(depth * x.shape[3] * x.shape[4])).to(x.dtype)


class DepthSplit:
    """One ResNet forward under a data mesh (None: one rank, where the
    rule splits nothing and every op is the plain one): the JAX rule's
    decisions and the split ops. An activation travels with its global
    depth, None while it is whole (the same on every rank)."""

    def __init__(self, mesh: DataMesh | None = None):
        self.mesh = mesh
        self.world, self.rank = ((1, 0) if mesh is None
                                 else (mesh.world_size, mesh.rank))
        # (op, planes of its input this rank read, the input's global
        # depth, whether it ran split) of every conv and pool, in order: what
        # a rank's share of the work is
        self.trace = []

    def block(self, depth: int) -> tuple:
        return partition(depth, self.world)[self.rank]

    def reshard(self, x: torch.Tensor, depth, next_stride: int):
        """The reshard hook before an op of stride next_stride -> (x,
        depth): this rank's block of a whole x where the rule splits,
        every rank's slabs gathered where it replicates."""
        d = x.shape[2] if depth is None else depth
        want = splits(d, next_stride, self.world)
        if depth is None and want:
            lo, hi = self.block(d)
            return x[:, :, lo:hi], d
        if depth is not None and not want:
            return all_gather_batch(x, self.mesh, n=depth, dim=2), None
        return x, depth

    def _windowed(self, op, x, depth, k, s, p, fill, what):
        """op(window) over this rank's block of the output planes (op runs
        with no depth padding) -> (y, output depth)."""
        wins = windows(depth, k, s, p, self.world)
        xw = halo_window(x, self.mesh, depth, wins, fill)
        self.trace.append((what, xw.shape[2], depth, True))
        d_out = out_depth(depth, k, s, p)
        lo, hi = self.block(d_out)
        y = op(xw)
        return (y if y.shape[2] == hi - lo else y[:, :, :hi - lo]), d_out

    def conv(self, mod, x, depth):
        """An nn.Conv3d (cubic kernel, stride and padding) -> (y, depth)."""
        if depth is None:
            self.trace.append(("conv", x.shape[2], x.shape[2], False))
            return mod(x), None
        k, s, p = mod.kernel_size[0], mod.stride[0], mod.padding[0]
        return self._windowed(
            lambda xw: F.conv3d(xw, mod.weight, mod.bias, s, (0, p, p)),
            x, depth, k, s, p, 0.0, "conv")

    def max_pool(self, x, depth, k: int = 3, s: int = 2, p: int = 1):
        if depth is None:
            self.trace.append(("pool", x.shape[2], x.shape[2], False))
            return F.max_pool3d(x, k, s, p), None
        return self._windowed(
            lambda xw: F.max_pool3d(xw, k, s, (0, p, p)), x, depth, k, s, p,
            float("-inf"), "pool")

    def batch_norm(self, bn, x, depth):
        """BatchNorm3d on x: global statistics over a split x in train
        mode, the module itself otherwise."""
        if depth is None or not bn.training:
            return bn(x)
        return bn.forward_split(x, *batch_norm_stats(x, depth, self.mesh))

    def mean(self, x, depth):
        if depth is None:
            return x.mean(dim=(2, 3, 4))
        return global_mean_pool(x, depth, self.mesh)
