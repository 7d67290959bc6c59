#!/usr/bin/env python3
"""Phase 12 of chip_smoke.py alone: the hash-encoding kernels on the card.

Run from the repository root on a machine with an NVIDIA H100:

    PYTHONPATH=. python3 scripts/hash_check.py

Builds the full-width hash vision pipeline (8 levels x 4 features, 2^19 rows
a level), takes the main path's points (a render chunk's and one hash joint
step's main field and grid bake, by a forward hook on the HashTable) and
runs chip_smoke.py's hash_check at random points of the three row counts,
at tcnn's 16 x 2 layout and at the path's points: the forward and the
backward against the plain version and its autograd, each timed beside it
and its bound, with the table-gradient atomics and the forward's L2 sector
requests at those points. Prints the card's name and power limit; imports
nothing of JAX.
"""

from __future__ import annotations

import json
import sys

import torch

import chip_smoke as cs
from neraf_tpu_torch.data.vision_data import camera_arrays, synthetic_cameras
from neraf_tpu_torch.engine.factory import build_vision_pipeline
from neraf_tpu_torch.ops.cuda import build


def main() -> int:
    if not torch.cuda.is_available():
        print("hash_check: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(f"nvidia-smi: {cs.smi('name,power.limit')}", flush=True)
    build.load()
    print(build.build_log(), flush=True)
    hvpipe = build_vision_pipeline(tiny=False, device=dev, seed=0,
                                   encoding="hash")
    H = W = 512
    arrays = camera_arrays(synthetic_cameras(8, H, W, hfov_deg=90.0, seed=0),
                           dev)
    rows = cs.hash_phase(torch, dev, hvpipe, arrays, H, W)
    print(json.dumps(rows))
    print(f"nvidia-smi: {cs.smi('name,power.limit')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
