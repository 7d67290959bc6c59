#!/usr/bin/env python3
"""What the depth split (parallel/depth_split.py) adds to a rank's ResNet
beside the device work it saves: ResNet3D-50 over a random 7 x 128^3
volume, train mode, bf16 autocast, forward and backward of the feature's
dot with a random cotangent, on one card.

Run from the repository root on a machine with one NVIDIA H100:

    python3 scripts/split_host_cost.py [--reps 5] [--out build/split_host_cost.json]

Each run: one warm-up, then --reps timed passes (medians), then one pass
under torch.profiler for the device's busy ms (the sum of its kernels'
and copies' own times; null when the trace holds no device time):

- whole: one rank's forward + backward (no mesh);
- local: each rank r of N (N 2 and 4) in this one process, on a mesh
  whose collectives are stand-ins on the card (an all_gather copies the
  rank's buffer into every slot, an all_reduce leaves its tensor; a
  one-process NCCL group answers the backend query, so bf16 travels as
  itself, as over NCCL): the slab's own device work and the split's host
  work (windows, plans, statistics, torch.cat) without transport, and the
  count and bytes of the collectives a forward + backward;
- gloo: 2 ranks spawned on card 0 over gloo, as chip_smoke.py phase 26
  runs them: each rank's ms with the ResNet split and whole, then a pass
  with every collective timed apart (a sync before and after it): their
  count and ms.

Per run: wall_ms (synchronised), host_ms (the clock when backward
returns, before the sync) and device_busy_ms. Prints one JSON line a
measurement with the card's name and power limit, and writes them all to
--out. It imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

R, BACKBONE = 128, "resnet50"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _resnet(torch, dev):
    """The ResNet, a random volume and a feature cotangent, from seed 0."""
    from neraf_tpu_torch.models.resnet3d import ResNet3D

    gen = torch.Generator().manual_seed(0)
    net = ResNet3D(BACKBONE, 1024)
    net.reset_parameters(gen)
    vol = torch.rand((1, R, R, R, 7), generator=gen)
    cot = torch.randn((1, net.feature_dim), generator=gen)
    return net.to(dev).train(), vol.to(dev), cot.to(dev)


def _step(torch, net, vol, cot, mesh):
    def run():
        net.zero_grad(set_to_none=True)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            feat = net(vol, mesh=mesh)
        (feat * cot).sum().backward()
    return run


def _busy_ms(torch, fn):
    """The device's busy ms over one call of fn: the kernels' and copies'
    own device times in a torch.profiler trace; None without any."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        total += getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
    return total / 1e3 if total > 0 else None


def _timed(torch, fn, reps: int, profiled: bool = True) -> dict:
    fn()
    torch.cuda.synchronize()
    walls, hosts = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        hosts.append((t1 - t0) * 1e3)
    return {"wall_ms": statistics.median(walls),
            "host_ms": statistics.median(hosts), "walls_ms": walls,
            "device_busy_ms": _busy_ms(torch, fn) if profiled else None}


class _Collectives:
    """torch.distributed's all_gather and all_reduce, counted (calls and
    bytes, by name) and either replaced by stand-ins on the card (`local`)
    or run and timed apart, a sync before and after each (`timed`)."""

    def __init__(self, torch, mode: str):
        self.torch, self.mode = torch, mode
        self.calls = {"all_gather": [0, 0, 0.0], "all_reduce": [0, 0, 0.0]}

    def _count(self, name, nbytes, fn):
        c = self.calls[name]
        c[0] += 1
        c[1] += nbytes
        if self.mode == "local":
            return None
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        self.torch.cuda.synchronize()
        c[2] += (time.perf_counter() - t0) * 1e3
        return out

    def __enter__(self):
        import torch.distributed as dist

        self.kept = dist.all_gather, dist.all_reduce
        gather, reduce = self.kept

        def all_gather(parts, x, group=None, async_op=False):
            if self.mode == "local":
                for p in parts:
                    p.copy_(x)
            return self._count("all_gather",
                               x.numel() * x.element_size() * len(parts),
                               lambda: gather(parts, x, group=group))

        def all_reduce(x, op=dist.ReduceOp.SUM, group=None, async_op=False):
            return self._count("all_reduce", x.numel() * x.element_size(),
                               lambda: reduce(x, op=op, group=group))

        dist.all_gather, dist.all_reduce = all_gather, all_reduce
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.all_gather, dist.all_reduce = self.kept

    def summary(self) -> dict:
        return {k: {"calls": c[0], "bytes": c[1],
                    **({"ms": c[2]} if self.mode == "timed" else {})}
                for k, c in self.calls.items()}


def _gloo_rank(rank: int, init: str, reps: int, out: str) -> None:
    """A rank of the gloo measurement: split, whole, then split with the
    collectives timed apart -> JSON at `out`."""
    import torch

    from neraf_tpu_torch.parallel.sharding import make_mesh

    mesh = make_mesh(2, ["cuda:0"] * 2, backend="gloo", rank=rank,
                     init_method=init)
    try:
        net, vol, cot = _resnet(torch, mesh.device)
        res = {}
        for what, m in (("split", mesh), ("whole", None)):
            mesh.barrier()
            res[what] = _timed(torch, _step(torch, net, vol, cot, m), reps,
                               profiled=False)
        mesh.barrier()
        with _Collectives(torch, "timed") as coll:
            _step(torch, net, vol, cot, mesh)()
        res["collectives"] = coll.summary()
        Path(out).write_text(json.dumps(res))
    finally:
        mesh.close()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default="build/split_host_cost.json")
    args = ap.parse_args()
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("split_host_cost: no CUDA device", file=sys.stderr)
        return 1
    from neraf_tpu_torch.parallel.sharding import DataMesh

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    rows = []

    def emit(row):
        row["card"] = card
        print(json.dumps(row), flush=True)
        rows.append(row)

    net, vol, cot = _resnet(torch, dev)
    emit({"run": "whole", **_timed(torch, _step(torch, net, vol, cot, None),
                                   args.reps)})
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        for n in (2, 4):
            for r in range(n):
                mesh = DataMesh(r, n, dev, dist.group.WORLD)
                with _Collectives(torch, "local") as coll:
                    _step(torch, net, vol, cot, mesh)()
                counts = coll.summary()
                with _Collectives(torch, "local"):
                    row = _timed(torch, _step(torch, net, vol, cot, mesh),
                                 args.reps)
                emit({"run": "local", "ranks": n, "rank": r,
                      "collectives": counts, **row})
    finally:
        dist.destroy_process_group()
    del net, vol, cot
    torch.cuda.empty_cache()

    init = f"tcp://127.0.0.1:{_free_port()}"
    outs = [Path(args.out).with_suffix(f".gloo{r}.json") for r in range(2)]
    outs[0].parent.mkdir(parents=True, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_gloo_rank, args=(r, init, args.reps, str(o)))
             for r, o in enumerate(outs)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(600)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if any(p.exitcode != 0 for p in procs):
        print(f"split_host_cost: gloo ranks exited "
              f"{[p.exitcode for p in procs]}", file=sys.stderr)
        return 1
    for r, o in enumerate(outs):
        emit({"run": "gloo", "ranks": 2, "rank": r,
              **json.loads(o.read_text())})
        o.unlink()
    Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
