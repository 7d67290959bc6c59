#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json, portbench/ and the
PyTorch/CUDA package neraf_tpu_torch on a machine with the card(s) the cell
asks for. Prints the numbers compared for `correct` on standard error and,
as the last line of standard output, one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer ones), device and checks (portbench/core/main.py).
"""

import time

STARTED = time.perf_counter()  # set-up is counted from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# caches at fixed paths inside the checkout; no library loads JAX or flax
for _key, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "nv_compute_cache")):
    os.environ[_key] = str(ROOT / "build" / "portbench" / _sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

if __name__ == "__main__":
    from portbench.core.main import main

    sys.exit(main(sys.argv[1:], STARTED))
