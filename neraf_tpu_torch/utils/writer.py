"""The run's metrics log (counterpart of neraf_tpu/utils/writer.py): one
JSON record a line in <run dir>/metrics.jsonl, {"step", "prefix", scalars
...}, flushed at every write. The JAX package also writes tensorboard
events when torch's SummaryWriter imports; the port writes the JSONL log
only (tensorboard is not a dependency of the port)."""

from __future__ import annotations

import json
from pathlib import Path


class MetricsWriter:
    def __init__(self, log_dir: str | Path):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.log_dir / "metrics.jsonl", "a")

    def write_scalars(self, step: int, scalars: dict, prefix: str = ""):
        record = {"step": step, "prefix": prefix, **{
            k: (float(v) if isinstance(v, (int, float)) or hasattr(v, "item") else v)
            for k, v in scalars.items()}}
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()

    def close(self):
        self._jsonl.close()
