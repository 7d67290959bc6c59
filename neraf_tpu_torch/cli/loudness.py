"""neraf-loudness for the port (counterpart of neraf_tpu/cli/loudness.py,
the reference's loudness_maps.ipynb flow).

Usage:
    python -m neraf_tpu_torch.cli.loudness --load-config RUN_DIR/config.yml
        --output-dir DIR [--load-dir CKPT_DIR] [--resolution 48]
        [--height H] [--source X Y Z]

Renders a (resolution x resolution) microphone grid over the audio box at
one height (default: the mean train mic height) for one source (default:
the mean train source pose) and the first train orientation, in one sweep
on the device, and writes loudness_db.npy (the RMS loudness in dB) and
loudness_map.png (the JAX CLI's image: viridis of the min-max normalised
map, resized to 512 x 512 by nearest neighbour). No Griffin-Lim: the
loudness is read off the magnitudes. It runs on the card; `main(argv,
device="cpu")` runs it on the CPU.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from neraf_tpu_torch.cli.evaluate import restore_latest
from neraf_tpu_torch.configs.config import load_config
from neraf_tpu_torch.engine.factory import build_pipeline
from neraf_tpu_torch.utils.png import write_png
from neraf_tpu_torch.viz.loudness import (
    loudness_image,
    loudness_map,
    render_loudness_grid,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="neraf-loudness")
    p.add_argument("--load-config", required=True)
    p.add_argument("--load-dir", default=None)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--resolution", type=int, default=48)
    p.add_argument("--height", type=float, default=None,
                   help="mic height; default: mean train mic height")
    p.add_argument("--source", type=float, nargs=3, default=None,
                   help="source position; default: mean train source pose")
    return p.parse_args(argv)


def main(argv=None, device="cuda") -> np.ndarray:
    """Render and write the loudness map -> the (res, res) map in dB."""
    args = parse_args(argv)
    cfg = load_config(args.load_config)
    bundle = build_pipeline(cfg, device=device)
    pipe = bundle.pipeline
    restore_latest(args, Path(args.load_config).parent, pipe)

    o = bundle.audio_train.outputs
    height = args.height if args.height is not None else float(
        np.mean(o.microphone_poses[:, 1]))
    source = (np.asarray(args.source) if args.source is not None
              else np.mean(o.source_poses, axis=0))
    out = render_loudness_grid(pipe.render_rirs, source, o.rotations[0],
                               pipe.audio_aabb.cpu().numpy(), height,
                               resolution=args.resolution)
    lm = loudness_map(out["log_stfts"], out["shape"])

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    np.save(out_dir / "loudness_db.npy", lm)
    write_png(out_dir / "loudness_map.png", loudness_image(lm))
    print(f"wrote loudness map ({args.resolution}x{args.resolution}, "
          f"height {height:.2f}) to {out_dir}")
    return lm


if __name__ == "__main__":
    main()
