"""One float32 joint step at full width on the card and on the CPU, from
the same state and draws: the worst relative gap of every loss and of
every gradient, and whether each is within 1e-3 (ROADMAP.md, fault (b)).

Both pipelines are the fourier joint step at full width
(build_joint_pipeline(grid_res=128, tiny=False)) in float32 with TF32
off, the audio branch live (step 3000), on bench.py's inputs
(chip_smoke.bench_inputs). The CPU pipeline takes the card's weights, grid
and draws, and runs its radiance fields' MLPs in float64, as
chip_smoke.py's phase 11 does: positions enter the fourier encoding at up
to 2^8 turns, which the card's kernels reduce exactly and a float32 chain
rounds by ~1e-4 rad. A loss's gap is |card - cpu| / |cpu|; a gradient's
(and the grid's, and each BatchNorm statistic's) is the largest absolute
difference over the CPU tensor's peak. The ReLU units whose input changes
sign between the two runs (kinks at the float32 noise floor,
chip_smoke.py::relu_flips) are listed with the tensors upstream of them.

With --pin-kinks the kinks are pinned instead: the CPU step runs first
and records the sign mask of every ReLU and leaky-ReLU input of the step
(with gradients on, in call order), and the card's step takes those masks
in place of its own (relu(x) as where(mask, x, 0), leaky_relu(x) as
where(mask, x, slope x)), so that both sides pass every cotangent through
the same units; the count of units whose sign the card would have
flipped is reported. The radiance fields' PE + MLP then run on both sides
through their plain chain (the card's: the encoding in float64, exactly
as the kernel reduces it, the layers in float32), whose ReLUs the masks
reach; inside the kernel they cannot. A diagnostic: the kernel stays the
main path.

    PYTHONPATH=. python3 scripts/full_step_card_vs_cpu.py [--out PATH]
        [--pin-kinks]

prints one JSON line and writes it to --out (default
build/full_step_card_vs_cpu.json); --tiny runs the tiny
configuration at grid 32 instead, and --device cpu puts the "card" side on
the CPU too (a dry run of the script); exit 1 if a value is not finite.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke
from neraf_tpu_torch.engine.factory import build_joint_pipeline

LIMIT = 1e-3  # ROADMAP.md fault (b): closed if every gap stays within it


def gap(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


class PinnedReLUs:
    """A torch function mode over a step: records the sign mask of every
    ReLU and leaky-ReLU input taken with gradients on (`masks` None), or
    imposes the masks it is given in call order, counting the units whose
    own sign differs (`flips`)."""

    def __init__(self, masks=None):
        import torch.nn.functional as F
        from torch.overrides import TorchFunctionMode

        self.masks, self.recorded, self.flips = masks, [], []
        funcs = {F.relu: 0.0, torch.relu: 0.0, F.leaky_relu: None}
        owner = self

        class Mode(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if func not in funcs or not torch.is_grad_enabled():
                    return func(*args, **kwargs)
                x = args[0]
                if owner.masks is None:
                    owner.recorded.append((tuple(x.shape),
                                           (x.detach() > 0).cpu()))
                    return func(*args, **kwargs)
                shape, mask = owner.masks[len(owner.flips)]
                if shape != tuple(x.shape):
                    raise RuntimeError(f"ReLU {len(owner.flips)}: shape "
                                       f"{tuple(x.shape)}, recorded {shape}")
                mask = mask.to(x.device)
                owner.flips.append(int(((x.detach() > 0) != mask).sum()))
                slope = funcs[func]
                if slope is None:
                    slope = (args[1] if len(args) > 1
                             else kwargs.get("negative_slope", 0.01))
                return torch.where(mask, x, x * slope)

        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def plain_pe_mlp(x, layers, num_frequencies=6, min_exp=0.0, max_exp=8.0,
                 dtype=torch.float32):
    """The PE + MLP's plain chain with the encoding in float64 (as the
    kernel reduces its angles exactly) and the layers in `dtype`."""
    from neraf_tpu_torch.ops.pe_mlp import pe_mlp_plain

    return pe_mlp_plain(x.double(), layers, num_frequencies, min_exp,
                        max_exp, dtype).to(torch.promote_types(
                            dtype, torch.float32))


def params(pipe) -> dict:
    """Every parameter by name, in the order a step's backward reaches
    them last (the vision fields, the camera correction, the acoustic
    field, the ResNet)."""
    vm = pipe.vision_model
    return {**{f"proposal_networks.{k}": t for k, t in
               vm.proposal_networks.named_parameters()},
            **{f"field.{k}": t for k, t in vm.field.named_parameters()},
            "camera_opt": vm.camera_opt,
            **{f"audio.{k}": t for k, t in pipe.audio_model.named_parameters()},
            **{f"resnet.{k}": t for k, t in pipe.resnet.named_parameters()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/full_step_card_vs_cpu.json")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pin-kinks", action="store_true")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("full_step_card_vs_cpu: no CUDA device", file=sys.stderr)
        return 1
    R = 32 if args.tiny else 128
    t0 = time.perf_counter()
    on = {side: build_joint_pipeline(grid_res=R, tiny=args.tiny, device=dev,
                                     seed=0, mixed_precision=False)
          for side, dev in (("card", args.device), ("cpu", "cpu"))}
    card, cpu = on["card"], on["cpu"]
    for field in (cpu.vision_model.field, *cpu.vision_model.proposal_networks):
        field.dtype = torch.float64
    for name in ("vision_model", "audio_model", "resnet"):
        getattr(cpu, name).load_state_dict(getattr(card, name).state_dict())
    cpu.grid = card.grid.cpu()
    for p in on.values():
        p.step = 3000  # past start_step_audio: the audio branch is live
    cams, audio, images = chip_smoke.bench_inputs(torch, card.device)
    data = {"card": (cams, audio, images),
            "cpu": tuple({k: v.cpu() for k, v in d.items()}
                         for d in (cams, audio, images))}
    n_cams, H, W = images["images"].shape[:3]
    draws = {k: v.cpu().numpy() for k, v in card.draw(
        n_cams, H, W, audio["log_stft"].shape[0]).items()}
    metrics, calls, seconds = {}, {}, {}
    if args.pin_kinks:
        from neraf_tpu_torch.fields import nerfacto

        nerfacto.pe_mlp = plain_pe_mlp
        pins = {}
        for side in ("cpu", "card"):
            t = time.perf_counter()
            masks = None if side == "cpu" else pins["cpu"].recorded
            with PinnedReLUs(masks) as pins[side]:
                metrics[side] = on[side].train_step(*data[side], draws=draws)
            seconds[side] = time.perf_counter() - t
        flips = pins["card"].flips
        if len(flips) != len(pins["cpu"].recorded):
            raise RuntimeError(f"the card took {len(flips)} ReLUs, the CPU "
                               f"{len(pins['cpu'].recorded)}")
        kinks = {"relus": len(flips), "pinned_units": sum(flips),
                 "relus_with_a_pinned_unit": sum(1 for f in flips if f)}
        upstream = set()
    else:
        for side, p in on.items():
            t = time.perf_counter()
            with chip_smoke.relu_inputs(torch, {"resnet": p.resnet,
                                                "audio": p.audio_model}) as calls[side]:
                metrics[side] = p.train_step(*data[side], draws=draws)
            seconds[side] = time.perf_counter() - t
    losses = {k: abs(metrics["card"][k] - v) / max(abs(v), 1e-30)
              for k, v in metrics["cpu"].items() if not k.startswith("lr_")}
    g_card, g_cpu = params(card), params(cpu)
    grads = {k: gap(g_card[k].grad, t.grad) for k, t in g_cpu.items()}
    names = {id(t): k for k, t in g_cpu.items()}
    if not args.pin_kinks:
        kinks, upstream = chip_smoke.relu_flips(
            torch, calls["card"], calls["cpu"], names, "full step")
    state = {"grid": gap(card.grid, cpu.grid), **{
        k: gap(v, cpu.resnet.state_dict()[k])
        for k, v in card.resnet.state_dict().items() if "running" in k}}
    over = [k for k, e in grads.items() if e > LIMIT]
    out = {
        "config": "tiny, grid 32" if args.tiny else "full width, grid 128",
        "pinned_kinks": args.pin_kinks,
        "card": (torch.cuda.get_device_name(0) if args.device == "cuda"
                 else args.device),
        "card_power_limit": (chip_smoke.smi("name,power.limit")
                             if args.device == "cuda" else None),
        "limit": LIMIT, "losses": losses,
        "worst_loss": max(losses.items(), key=lambda kv: kv[1]),
        "worst_gradient": max(grads.items(), key=lambda kv: kv[1]),
        "gradients": grads, "state": state,
        "worst_state": max(state.items(), key=lambda kv: kv[1]),
        "first_gradient_over_limit": over[0] if over else None,
        "gradients_over_limit": {k: grads[k] for k in over},
        "over_limit_upstream_of_a_kink": sorted(set(over) & upstream),
        "kinks": kinks,
        "within_limit": (max(losses.values()) <= LIMIT and not over),
        "step_seconds": seconds, "wall_s": time.perf_counter() - t0,
    }
    line = json.dumps(out)
    print(line, flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(line + "\n")
    finite = all(np.isfinite(v) for v in (*losses.values(), *grads.values(),
                                           *state.values()))
    return 0 if finite else 1


if __name__ == "__main__":
    sys.exit(main())
