"""neraf-viewer for the port (counterpart of neraf_tpu/cli/viewer.py, the
reference's ns-viewer): the HTTP viewer of viz/viewer.py on a trained run.

Usage:
    python -m neraf_tpu_torch.cli.viewer --load-config RUN_DIR/config.yml
        [--load-dir CKPT_DIR] [--host 127.0.0.1] [--port 7007]
        [--dry-audio-dir DIR]

--port 0 binds a free port; the bound address is printed. It runs on the
card; `main(argv, device="cpu")` runs it on the CPU, and
`main(argv, blocking=False)` returns the server, serving from a daemon
thread (stop it with server.shutdown()).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from neraf_tpu_torch.cli.evaluate import restore_latest
from neraf_tpu_torch.configs.config import load_config
from neraf_tpu_torch.engine.factory import build_pipeline
from neraf_tpu_torch.viz.viewer import ViewerBackend, serve


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="neraf-viewer")
    p.add_argument("--load-config", required=True)
    p.add_argument("--load-dir", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7007)
    p.add_argument("--dry-audio-dir", default=None,
                   help="directory of dry wavs servable via GET /auralize "
                        "(disabled when unset; POST works regardless)")
    return p.parse_args(argv)


def main(argv=None, device="cuda", blocking: bool = True):
    """Serve the run's latest checkpoint -> the server (when blocking,
    after it stops)."""
    args = parse_args(argv)
    pipe = build_pipeline(load_config(args.load_config), device=device).pipeline
    restore_latest(args, Path(args.load_config).parent, pipe)
    backend = ViewerBackend(pipe, dry_audio_dir=args.dry_audio_dir)
    return serve(backend, host=args.host, port=args.port, blocking=blocking)


if __name__ == "__main__":
    main()
