#!/usr/bin/env python3
"""Plant a dropped collective of the depth-split ResNet on a card and read
which of chip_smoke.py phase 26's gates fail it.

Run from the repository root on a machine with one NVIDIA H100:

    python3 scripts/split_mutants_card.py [--out build/split_mutants.json]

For the intact split, then for each mutant of tests/torch_parallel_ranks.py's
SPLIT_MUTANTS (the halo exchange, the BatchNorm reduction or the final
pool's sum over ranks dropped) and for a wrong factor of N (the pool's sum
over ranks divided by the rank's own voxel count): phase 26's two gloo
ranks on card 0 against one rank (chip_smoke.mesh_run, the mutant planted
in both ranks' processes), one bf16 split step and the float32 split step,
no sweep; then chip_smoke.mesh_gates. Prints one JSON line a run, the
gates that failed and what they read, and writes them all to --out. Exits
1 when the intact split fails a gate or a mutant passes every gate. It
imports no JAX.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "tests")]

import chip_smoke  # noqa: E402
from torch_parallel_ranks import SPLIT_MUTANTS  # noqa: E402

# one bf16 split step, the stem kernel's gate off
VARIANTS = (("split", False, 1),)


def _pool_over_rank_count(x, depth, mesh):
    """global_mean_pool over this rank's voxel count: the summed slabs
    over a count N times too small."""
    import torch

    from neraf_tpu_torch.parallel.sharding import all_reduce_sum

    acc = torch.promote_types(x.dtype, torch.float32)
    s = all_reduce_sum(x.to(acc).sum(dim=(2, 3, 4)), mesh)
    return (s / float(x.shape[2] * x.shape[3] * x.shape[4])).to(x.dtype)


MUTANTS = {**SPLIT_MUTANTS,
           "pool_times_n": ("global_mean_pool", _pool_over_rank_count)}


def plant(name: str | None):
    """Replace the depth split's function that `name` mutates -> what it
    replaced, to put back (None: nothing planted)."""
    from neraf_tpu_torch.parallel import depth_split

    if name is None:
        return None
    attr, fn = MUTANTS[name]
    kept = getattr(depth_split, attr)
    setattr(depth_split, attr, fn)
    return attr, kept


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/split_mutants.json")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("split_mutants_card: no CUDA device", file=sys.stderr)
        return 1
    from neraf_tpu_torch.ops.cuda import build
    from neraf_tpu_torch.parallel import depth_split

    build.load()  # once, before the spawned rank looks for it
    smi_line = chip_smoke.smi("name,power.limit")
    dev = torch.device("cuda")
    results, wrong = [], []
    for name in (None, *MUTANTS):
        kept = plant(name)
        try:
            with tempfile.TemporaryDirectory() as tmp:
                r0, rest, wall = chip_smoke.mesh_run(
                    torch, dev, Path(tmp), VARIANTS, sweep=False,
                    setup=functools.partial(plant, name))
            bad, report = chip_smoke.mesh_gates(r0, rest, VARIANTS,
                                                sweep=False)
        except SystemExit:  # a rank failed (chip_smoke.fail)
            bad, report, wall = [("rank_failed", "a rank failed")], {}, None
        finally:
            if kept is not None:
                setattr(depth_split, *kept)
        row = {"mutant": name or "intact",
               "failed_gates": sorted({g for g, _ in bad}),
               "messages": [m for _, m in bad], "report": report,
               "wall_s": wall, "card": smi_line}
        print(json.dumps(row), flush=True)
        results.append(row)
        if (name is None) == bool(bad):
            wrong.append(row["mutant"])
        torch.cuda.empty_cache()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    summary = {r["mutant"]: r["failed_gates"] for r in results}
    print(f"split mutants ({smi_line}): failed gates {json.dumps(summary)}",
          flush=True)
    if wrong:
        print(f"split_mutants_card: wrong outcome for {wrong}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
