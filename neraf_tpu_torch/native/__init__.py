"""Native (C++) host ingest (counterpart of neraf_tpu/native): WAV decode,
polyphase resample, STFT magnitudes and a batched wav -> magnitude runner
on a std::thread pool, the replacement of the reference's DataLoader
workers. It is host code; what it returns goes to the card as any array.

``ingest.cpp`` (the port's own copy; its STFT is a radix-2 FFT, n_fft a
power of two) is compiled with g++ at first use into
``build/neraf_tpu_torch/`` beside the package, named by a hash of the
source, the flags, the compiler's version and the machine, and loaded with
ctypes. Nothing is built when this module is imported.

There is no silent fallback. ``NERAF_NATIVE=0`` is the one way to take the
Python path (``available()`` is then False); otherwise a missing compiler or
a failed build raises with the compiler's output. The one fallback left is
the RAF loader's on a wav the library refuses (a format the parser does not
cover, or samples it cannot decode): that file takes the Python path, as in
the JAX package, and each such file is warned about and counted by
``fallbacks()``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import platform
import shutil
import subprocess
import warnings
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "ingest.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "neraf_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_FALLBACKS = 0


class BatchError(IOError):
    """process_rir_batch's failure: ``paths``, the files that failed; ``mags``
    and ``channels``, the batch's arrays (a failed file's channel count 0)."""

    def __init__(self, msg: str, paths: list, mags: np.ndarray,
                 channels: np.ndarray):
        super().__init__(msg)
        self.paths, self.mags, self.channels = paths, mags, channels


def _compiler() -> tuple[str, str]:
    """(g++'s path, its --version); raises if there is none."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(
            "g++ not found: the native ingest needs a C++ compiler on PATH "
            "(NERAF_NATIVE=0 takes the Python path instead)")
    ver = subprocess.run([cxx, "--version"], capture_output=True, text=True,
                         timeout=60).stdout
    return cxx, ver


def library_path() -> Path:
    """Where the library for this source, these flags, this compiler and
    this machine lives."""
    _, ver = _compiler()
    h = hashlib.sha256("\0".join((*CXX_FLAGS, ver, platform.machine(),
                                   *platform.libc_ver())).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libneraf_ingest_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    cxx, _ = _compiler()
    so.parent.mkdir(parents=True, exist_ok=True)
    # a name of this process's own: concurrent builds rename atomically
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, so)


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises on failure."""
    so = library_path()
    if not so.exists():
        _build(so)
    lib = ctypes.CDLL(str(so))
    fp, ip, ci = (ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
                  ctypes.c_int)
    lib.neraf_wav_info.argtypes = [ctypes.c_char_p, ip, ip, ip]
    lib.neraf_wav_read.argtypes = [ctypes.c_char_p, fp, ci]
    lib.neraf_resample_poly.argtypes = [fp, ci, ci, ci, ci, ctypes.c_double,
                                        fp, ci]
    lib.neraf_stft_mag.argtypes = [fp, ci, ci, ci, ci, fp, ci]
    lib.neraf_process_rir_batch.argtypes = (
        [ctypes.POINTER(ctypes.c_char_p)] + [ci] * 12 + [fp, ip])
    for f in (lib.neraf_wav_info, lib.neraf_wav_read, lib.neraf_resample_poly,
              lib.neraf_stft_mag, lib.neraf_process_rir_batch):
        f.restype = ci
    return lib


def available() -> bool:
    """Whether the native path is taken: False under NERAF_NATIVE=0 (read at
    each call), else True once the library is built and loaded (raises if
    it cannot be)."""
    if os.environ.get("NERAF_NATIVE", "1") == "0":
        return False
    load()
    return True


def fallbacks() -> int:
    """How many files took the Python path because the parser refused them."""
    return _FALLBACKS


def reset_fallbacks() -> None:
    global _FALLBACKS
    _FALLBACKS = 0


def count_fallback(path, why: Exception) -> None:
    """Record (and warn about) one file that takes the Python path."""
    global _FALLBACKS
    _FALLBACKS += 1
    warnings.warn(f"native ingest refused {path} ({why}); it takes the "
                  f"Python path", RuntimeWarning, stacklevel=3)


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _check_n_fft(n_fft: int) -> None:
    if n_fft < 2 or n_fft & (n_fft - 1):
        raise ValueError(f"native STFT: n_fft {n_fft} is not a power of two")


def wav_info(path) -> tuple[int, int, int]:
    """(sample_rate, frames, channels) of a wav, samples not decoded."""
    sr, frames, ch = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if load().neraf_wav_info(str(path).encode(), ctypes.byref(sr),
                             ctypes.byref(frames), ctypes.byref(ch)) != 0:
        raise IOError(f"native wav parse failed: {path}")
    return sr.value, frames.value, ch.value


def read_wav(path) -> tuple[int, np.ndarray]:
    """(sr, (n,) or (n, C) float32), as utils/wav.py::read_wav."""
    sr, frames, ch = wav_info(path)
    buf = np.empty((ch, frames), np.float32)
    if load().neraf_wav_read(str(path).encode(), _fptr(buf), buf.size) != 0:
        raise IOError(f"native wav read failed: {path}")
    return sr, np.ascontiguousarray(buf.T if ch > 1 else buf[0])


def resample_poly(x: np.ndarray, up: int, down: int, *, num_zeros: int = 24,
                  beta: float = 8.555) -> np.ndarray:
    """Polyphase resample of the last axis, as dsp/resample.py."""
    lib = load()
    g = math.gcd(up, down)
    up, down = up // g, down // g
    x = np.ascontiguousarray(x, np.float32)
    flat = x.reshape(-1, x.shape[-1])
    out_len = -(-x.shape[-1] * up // down)
    out = np.empty((flat.shape[0], out_len), np.float32)
    for i in range(flat.shape[0]):
        lib.neraf_resample_poly(_fptr(flat[i]), flat.shape[1], up, down,
                                num_zeros, beta, _fptr(out[i]), out_len)
    return out.reshape(x.shape[:-1] + (out_len,))


def stft_magnitude(x: np.ndarray, *, n_fft: int, hop_length: int,
                   win_length: int | None = None) -> np.ndarray:
    """torch-convention STFT magnitudes (..., F, T), as dsp/stft.py."""
    _check_n_fft(n_fft)
    lib = load()
    win_length = n_fft if win_length is None else win_length
    x = np.ascontiguousarray(x, np.float32)
    flat = x.reshape(-1, x.shape[-1])
    n_frames = 1 + x.shape[-1] // hop_length
    n_freq = n_fft // 2 + 1
    out = np.empty((flat.shape[0], n_freq, n_frames), np.float32)
    for i in range(flat.shape[0]):
        lib.neraf_stft_mag(_fptr(flat[i]), flat.shape[1], n_fft, hop_length,
                           win_length, _fptr(out[i]), n_frames)
    return out.reshape(x.shape[:-1] + (n_freq, n_frames))


def process_rir_batch(paths, *, target_fs: int, n_fft: int, hop: int,
                      win: int, front_pad: int = 0, min_samples: int = 0,
                      max_samples: int = 0, max_channels: int = 2,
                      n_frames: int, n_threads: int | None = None,
                      clip: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """Wavs -> ((N, max_channels, F, n_frames) magnitudes, (N,) channel
    counts) on a native thread pool: clip (optional), resample to target_fs
    (0: keep), front-pad, zero-extend to min_samples, cut to max_samples (0:
    no cap), STFT per channel; frames and channels past a file's own are
    zero. Raises BatchError (an IOError) naming the files that failed and
    holding the others' arrays."""
    _check_n_fft(n_fft)
    lib = load()
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    n = len(paths)
    out = np.zeros((n, max_channels, n_fft // 2 + 1, n_frames), np.float32)
    ch_out = np.zeros((n,), np.int32)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    failed = lib.neraf_process_rir_batch(
        arr, n, target_fs, n_fft, hop, win, front_pad, min_samples,
        max_samples, max_channels, n_frames, n_threads, int(clip),
        _fptr(out), ch_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    if failed:
        bad = [p for p, c in zip(paths, ch_out) if c == 0]
        raise BatchError(f"native ingest failed for {failed} file(s): "
                         f"{[str(p) for p in bad[:5]]}", bad, out, ch_out)
    return out, ch_out
