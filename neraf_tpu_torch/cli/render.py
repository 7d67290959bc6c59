"""neraf-render for the port (counterpart of neraf_tpu/cli/render.py, the
reference's ns-render).

Usage:
    python -m neraf_tpu_torch.cli.render --load-config RUN_DIR/config.yml
        [--load-dir CKPT_DIR] --output-dir DIR [--split eval|train]

Loads the run's config.yml and its latest checkpoint (under
<run dir>/neraf_models, or --load-dir) and renders every view of the
split: render_{i:04d}.png (uint8 RGB) and depth_{i:04d}.npy (float32), as
the JAX CLI writes them. Each view is JointPipeline.render_image: the
PE+MLP forward kernel on a card, three launches a 32,768-ray chunk (one
hash forward and two PE+MLP on a hash run). It runs on the card;
`main(argv, device="cpu")` runs it on the CPU.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from neraf_tpu_torch.cli.evaluate import restore_latest
from neraf_tpu_torch.configs.config import load_config
from neraf_tpu_torch.data.vision_data import camera_arrays
from neraf_tpu_torch.engine.factory import build_pipeline
from neraf_tpu_torch.utils.png import quantize_rgb, write_png


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="neraf-render")
    p.add_argument("--load-config", required=True)
    p.add_argument("--load-dir", default=None)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--split", default="eval", choices=["eval", "train"])
    return p.parse_args(argv)


def main(argv=None, device="cuda") -> Path:
    """Render the split's views -> the output directory."""
    args = parse_args(argv)
    cfg = load_config(args.load_config)
    bundle = build_pipeline(cfg, device=device)
    pipe = bundle.pipeline
    restore_latest(args, Path(args.load_config).parent, pipe)

    ds = bundle.vision_eval if args.split == "eval" else bundle.vision_train
    if ds is None:
        raise ValueError(f"{args.load_config}: the run has no vision data "
                         "(vision_data.data_dir is empty)")
    cams = camera_arrays(ds.cameras, device)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    H, W = ds.cameras.height, ds.cameras.width
    for i in range(len(ds.cameras)):
        out = pipe.render_image(cams, i, H, W)
        write_png(out_dir / f"render_{i:04d}.png", quantize_rgb(out["rgb"]))
        np.save(out_dir / f"depth_{i:04d}.npy",
                out["depth"].float().cpu().numpy())
    print(f"rendered {len(ds.cameras)} views to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
