"""The counterpart of __graft_entry__.dryrun_multichip: one sharded joint
train step on resident audio arrays and one on the streaming input
structure, on a mesh of n ranks.

Like the JAX dry run (__graft_entry__.py:192-264), the mesh is
make_mesh_2d(n // 2, 2) for n >= 4 (the acoustic field's layers with >=
512 outputs column-sharded over the model axis) and make_mesh(n) below;
the pipeline is the JAX dry run's tiny one (grid 16, resnet18, the default
mixed precision, 16 n STFT slices, 32 n rays and 16 n bake cells a step,
the audio branch live from step 0) on its constant inputs. Each rank is a
process of its own (spawned here, gloo or NCCL as make_mesh picks or
`backend` says) meeting at a file rendezvous in a temporary directory.

    python -m neraf_tpu_torch.parallel.dryrun 4 [--device cpu]

runs 4 ranks on the CPU or on the cards (one a rank; `--shared-card` puts
every rank on card 0 over gloo) and prints the JAX dry run's line.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import shutil
import sys
import tempfile
import time
from pathlib import Path

import torch

JOIN_S = 600  # the ranks' deadline


def dryrun_pipeline(n_devices: int, mesh):
    """The JAX dry run's tiny joint pipeline (__graft_entry__._build_pipeline
    with tiny=True) on the rank's device."""
    from neraf_tpu_torch.configs.config import ExperimentConfig, VisionModelConfig
    from neraf_tpu_torch.engine.factory import (
        AUDIO_AABB,
        _joint_pipeline,
        audio_model_config,
    )

    cfg = ExperimentConfig(dataset="SoundSpaces")
    cfg.vision_model = VisionModelConfig(
        num_levels=4, log2_hashmap_size=10, base_res=4, max_res=32,
        hidden_dim=16, hidden_dim_color=16, geo_feat_dim=7,
        appearance_embed_dim=4, num_nerf_samples=8,
        num_proposal_samples=(16, 12))
    cfg.audio_model = audio_model_config(tiny=True)
    cfg.audio_data.batch_size = 16 * n_devices
    cfg.vision_data.train_rays_per_batch = 32 * n_devices
    cfg.trainer.grid_bake_cells_per_step = 16 * n_devices
    cfg.trainer.start_step_audio = 0
    return _joint_pipeline(cfg, 8, AUDIO_AABB, 16, mesh.device, 0, mesh)


def dryrun_inputs(pipe) -> tuple:
    """The JAX dry run's cameras (4 identity poses, 8 x 8 pixels), images
    (all 0.5) and resident audio arrays (8 recordings at -6.9), and its
    streamed batch (the global batch of pre-gathered STFT columns with
    the pose tables), on the pipeline's device."""
    dev = pipe.device
    n_cams, H, W, n_rec = 4, 8, 8, 8
    c2w = torch.cat([torch.eye(3), torch.zeros(3, 1)], dim=1)
    cams = {"c2w": c2w.expand(n_cams, 3, 4).contiguous().to(dev),
            "fx": torch.full((n_cams,), 10.0, device=dev),
            "fy": torch.full((n_cams,), 10.0, device=dev),
            "cx": torch.full((n_cams,), W / 2, device=dev),
            "cy": torch.full((n_cams,), H / 2, device=dev)}
    images = {"images": torch.full((n_cams, H, W, 3), 0.5, device=dev)}
    acfg = pipe.audio_model.config
    F, T = acfg.n_freq_stft, acfg.max_len
    poses = {"mic_pose": torch.zeros(n_rec, 3, device=dev),
             "source_pose": torch.zeros(n_rec, 3, device=dev),
             "rot": torch.full((n_rec, 3), 0.5, device=dev)}
    audio = {**poses, "log_stft": torch.full((n_rec, 2, F, T), -6.9,
                                             device=dev)}
    B = pipe.config.audio_data.batch_size
    ar = torch.arange(B, device=dev)
    stream = {**poses, "audio_idx": ar % n_rec, "time_query": ar % T,
              "data": torch.full((B, 2, F), -6.9, device=dev)}
    return cams, images, audio, stream


def _rank(rank: int, n: int, devices: list, backend, init: str, out: str,
          threads: int) -> None:
    """One rank of the dry run: its metrics of both steps to `out`."""
    from neraf_tpu_torch.parallel.sharding import (
        broadcast_state,
        make_mesh,
        make_mesh_2d,
        mesh_axis,
        shard_batch,
    )

    torch.set_num_threads(threads)
    if n >= 4:
        mesh = make_mesh_2d(n // 2, 2, devices, backend, rank=rank,
                            init_method=init)
    else:
        mesh = make_mesh(n, devices, backend, rank=rank, init_method=init)
    try:
        pipe = dryrun_pipeline(n, mesh)
        broadcast_state(pipe, mesh)
        if mesh_axis(mesh, "model"):
            # tensor-shard the wide acoustic-MLP kernels, as the JAX dry run
            pipe.shard_field(min_dim=512)
        cams, images, audio, stream = dryrun_inputs(pipe)
        m1 = pipe.train_step(cams, audio, images)
        if not (torch.isfinite(torch.tensor(m1["total_loss"]))
                and pipe.step == 1):
            raise RuntimeError(f"step 1: total_loss {m1['total_loss']}, "
                               f"step {pipe.step}")
        # the streaming input structure: the rank's block of the batch
        block = {**stream, **shard_batch(
            {k: stream[k] for k in ("audio_idx", "time_query", "data")}, mesh)}
        m2 = pipe.train_step(cams, block, images)
        if not (torch.isfinite(torch.tensor(m2["total_loss"]))
                and pipe.step == 2):
            raise RuntimeError(f"streaming step: total_loss "
                               f"{m2['total_loss']}, step {pipe.step}")
        Path(out).write_text(json.dumps({
            "rank": rank, "data": mesh.rank, "model": mesh.model_rank,
            "axes": list(mesh.axis_names), "metrics": [m1, m2],
            "sharded": sorted(pipe.audio_model.field.placements)}))
    finally:
        mesh.close()


def dryrun_multichip(n_devices: int, devices=None,
                     backend: str | None = None) -> list:
    """Spawn n_devices ranks (rank i on devices[i]; default every card,
    as make_mesh) that each run the dry run's two steps; raise if a rank
    fails or a loss is not finite; print the JAX dry run's line -> each
    rank's record (metrics of both steps, its mesh coordinates, its
    sharded field parameters)."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [str(d) for d in devices][:n_devices]
    if len(devices) < n_devices:
        raise ValueError(f"requested {n_devices} devices, have "
                         f"{len(devices)}")
    tmp = Path(tempfile.mkdtemp(prefix="neraf_dryrun_"))
    ctx = multiprocessing.get_context("spawn")
    threads = max(1, torch.get_num_threads() // n_devices)
    procs = [ctx.Process(target=_rank, args=(
        r, n_devices, devices, backend, f"file://{tmp}/rendezvous",
        str(tmp / f"rank{r}.json"), threads), daemon=True)
        for r in range(n_devices)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + JOIN_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        if any(p.is_alive() for p in procs):
            raise RuntimeError(f"dryrun_multichip({n_devices}): ranks still "
                               f"running after {JOIN_S} s")
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"dryrun_multichip({n_devices}): ranks "
                               f"exited {codes}")
        records = [json.loads((tmp / f"rank{r}.json").read_text())
                   for r in range(n_devices)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    total, total2 = (records[0]["metrics"][i]["total_loss"] for i in (0, 1))
    print(f"dryrun_multichip({n_devices}) OK: total_loss={total:.5f} "
          f"streaming_total_loss={total2:.5f}", flush=True)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--shared-card", action="store_true")
    args = ap.parse_args(argv)
    n = args.n_devices
    if args.device == "cpu":
        dryrun_multichip(n, ["cpu"] * n)
    elif args.shared_card:
        dryrun_multichip(n, ["cuda:0"] * n, backend="gloo")
    else:
        dryrun_multichip(n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
