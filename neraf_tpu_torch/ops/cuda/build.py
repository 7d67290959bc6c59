"""Build the package's CUDA sources with nvcc into one shared library.

The sources under ``neraf_tpu_torch/csrc`` expose a plain C interface and are
loaded with ``ctypes``: compiling them with nvcc alone takes seconds, where a
PyTorch C++ extension (``torch.utils.cpp_extension.load``) takes minutes. Each
source is compiled by its own nvcc process, all started together, and the
objects are linked into one library, built at first use into
``build/neraf_tpu_torch/`` beside the package and named by a hash of the
sources and flags, so an unchanged tree reuses it and a changed one
rebuilds. Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "neraf_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit on PATH or under /usr/local/cuda")
    return path


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libneraf_kernels_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on failure."""
    lib_path = library_path()
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        # one nvcc per source, all at once, then one link
        jobs = []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            obj = tmp.with_suffix(f".{src.stem}.o")
            cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        logs = []
        try:
            for cmd, _, proc in jobs:
                _, err = proc.communicate()
                logs.append(f"{' '.join(cmd)}\n{err}")
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                       f"{logs[-1]}")
        finally:
            for _, _, proc in jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        cmd = [_nvcc(), "-shared", "-o", str(tmp),
               *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        for _, obj, _ in jobs:
            obj.unlink()
        os.replace(tmp, lib_path)
        lib_path.with_suffix(".log").write_text(
            f"build_seconds={time.perf_counter() - t0:.2f}\n" + "".join(logs))
    lib = ctypes.CDLL(str(lib_path))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.neraf_gl_launch.argtypes = [vp] * 8 + [ci] * 6 + [cf] + [ci] * 2 + [vp]
    lib.neraf_gl_launch.restype = ci
    lib.neraf_gl_blocks_per_sm.argtypes = [ci] * 3 + [ctypes.POINTER(ci)]
    lib.neraf_gl_blocks_per_sm.restype = ci
    lib.neraf_pe_mlp_launch.argtypes = [vp] * 5 + [ci] * 9 + [vp]
    lib.neraf_pe_mlp_launch.restype = ci
    lib.neraf_pe_mlp_bwd_launch.argtypes = [vp] * 10 + [ci] * 10 + [vp]
    lib.neraf_pe_mlp_bwd_launch.restype = ci
    ip = ctypes.POINTER(ci)
    lib.neraf_hash_encoding_launch.argtypes = [vp] * 3 + [ci] * 4 + [ip] * 2 + [vp]
    lib.neraf_hash_encoding_launch.restype = ci
    lib.neraf_hash_encoding_bwd_launch.argtypes = (
        [vp] * 5 + [ci] * 4 + [ip] * 2 + [vp])
    lib.neraf_hash_encoding_bwd_launch.restype = ci
    lib.neraf_stem_wgrad_launch.argtypes = [vp] * 5 + [ci] * 9 + [vp]
    lib.neraf_stem_wgrad_launch.restype = ci
    lib.neraf_shifted_concat_launch.argtypes = [vp] * 2 + [ci] * 4 + [vp]
    lib.neraf_shifted_concat_launch.restype = ci
    lib.neraf_field_head_launch.argtypes = [vp] * 7 + [ci] * 10 + [vp]
    lib.neraf_field_head_launch.restype = ci
    lib.neraf_cuda_error_string.argtypes = [ci]
    lib.neraf_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build_log() -> str:
    """The nvcc command, build time and ptxas report of the loaded library."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else "(library built elsewhere)"


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.neraf_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
