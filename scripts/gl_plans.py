#!/usr/bin/env python3
"""Time the Griffin-Lim CUDA kernel under other launch plans, on the card.

Run from the repository root on a machine with an NVIDIA H100:

    PYTHONPATH=. python3 scripts/gl_plans.py [WARPS ...]

First the checks of chip_smoke.py's phase 3 (the kernel against
griffin_lim_plain at the SoundSpaces and RAF geometries, two launches bitwise
equal). Then, at 1024 SoundSpaces channels and 32 iterations, the plan of
ops/cuda/griffin_lim.py::gl_launch_plan against a block of each number of
warps given on the command line (put in gl_launch_plan's place for the
call), in turns (default, other, other, default), each other plan's output
bitwise equal to the default's, with the blocks each plan keeps resident on
an SM. Prints the card's name and power limit; imports nothing of JAX.
"""

from __future__ import annotations

import sys

import torch

import chip_smoke as cs
from neraf_tpu_torch.dsp.griffin_lim import random_angles
from neraf_tpu_torch.ops.cuda import build
from neraf_tpu_torch.ops.cuda import griffin_lim as gl_cuda


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("gl_plans: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(f"nvidia-smi: {cs.smi('name,power.limit')}", flush=True)
    build.load()
    print(build.build_log(), flush=True)
    for _, n_fft, hop, win, T, M in cs.GL_SHAPES:
        cs.gl_check(torch, dev, n_fft, hop, win, T, M)

    n_fft, hop, win, T, M = 512, 128, 512, 78, 1024
    length = hop * (T - 1)
    gen = torch.Generator().manual_seed(M)
    mag = cs.rir_like_magnitudes(M, n_fft, hop, win, T, gen).to(dev)
    ang = random_angles(mag.shape, gen, dev)
    default = gl_cuda.gl_launch_plan(n_fft, hop, T, length)
    chosen = gl_cuda.gl_launch_plan

    def run(plan):
        gl_cuda.gl_launch_plan = lambda *_: plan
        try:
            return gl_cuda.griffin_lim_cuda(mag, ang, n_fft=n_fft,
                                            hop_length=hop, win_length=win)
        finally:
            gl_cuda.gl_launch_plan = chosen

    ref = run(default)
    for arg in argv:
        warps = int(arg)
        plan = gl_cuda.GLPlan(warps, gl_cuda.gl_smem_bytes(
            n_fft, hop, T, length, warps))
        if not torch.equal(run(plan), ref):
            cs.fail(f"plan {plan} differs from {default}")
        d1, o1, o2, d2 = (cs.cuda_ms(torch, lambda p=p: run(p), 3)
                          for p in (default, plan, plan, default))
        print(f"gl plans, SoundSpaces M={M}, 32 iter: {default}, "
              f"{cs.gl_blocks_per_sm(n_fft, default)} blocks an SM, "
              f"{(d1 + d2) / 2:.3f} ms [{d1:.3f}, {d2:.3f}]; {plan}, "
              f"{cs.gl_blocks_per_sm(n_fft, plan)} blocks an SM, "
              f"{(o1 + o2) / 2:.3f} ms [{o1:.3f}, {o2:.3f}]", flush=True)
    print(f"nvidia-smi: {cs.smi('name,power.limit')}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
