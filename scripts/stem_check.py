#!/usr/bin/env python3
"""Phase 16 of chip_smoke.py alone: the folded stem and the stem
weight-gradient kernel on the card.

Run from the repository root on a machine with an NVIDIA H100:

    PYTHONPATH=. python3 scripts/stem_check.py

At the joint step's shape (a 7 x 128^3 grid folded to 56 x 64^3, bf16):
the fold of the flat grid, cuDNN's folded conv forward, weight gradient and
full-volume input gradient, and the slab input gradient, each timed beside
its bound with its device kernels; the s2d stem against the direct conv in
float64 and the slab gradient against the full-volume one. Then the kernel
on the folded volume against stem_wgrad_folded_plain in float64 at the
step's shape, a small cube and two D != H != W volumes, bf16 and f32, each
timed beside the plain version and cuDNN's weight gradient. Prints the
card's name and power limit; imports nothing of JAX.
"""

from __future__ import annotations

import json
import sys

import torch

import chip_smoke as cs
from neraf_tpu_torch.ops.cuda import build


def main() -> int:
    if not torch.cuda.is_available():
        print("stem_check: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(f"nvidia-smi: {cs.smi('name,power.limit')}", flush=True)
    build.load()
    print(build.build_log(), flush=True)
    rows = {"folded_stem": cs.stem_folded(torch, dev, 128, 4096)}
    for name, shape, cin, seed in cs.STEM_SHAPES:
        rows[name] = cs.stem_check(torch, dev, name, shape, cin, seed)
    print(json.dumps(rows))
    print(f"nvidia-smi: {cs.smi('name,power.limit')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
