"""WAV read/write helpers (counterpart of neraf_tpu/utils/wav.py):
scipy-backed, float32 in [-1, 1]."""

from __future__ import annotations

from pathlib import Path

import numpy as np
from scipy.io import wavfile


def read_wav(path: str | Path) -> tuple[int, np.ndarray]:
    """Read a wav as float32 in [-1, 1]; shape (n,) or (n, C) as stored."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    return sr, data


def write_wav(path: str | Path, fs: int, data: np.ndarray) -> None:
    """Write float32 audio in [-1, 1]; (n,) or (n, C)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    wavfile.write(path, fs, np.asarray(data, dtype=np.float32))
