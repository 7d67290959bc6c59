"""A materialised STFT-slice split (counterpart of
neraf_tpu/data/datasets.py): poses, every recording's full log-magnitude
STFT (N, C, F, max_len) and the eval waveforms, in host memory;
`slice_arrays` puts the sampler's arrays on a device. The loaders read a
RAF or a SoundSpaces scene from disk (the JAX loaders' Python path; their
optional native C++ ingest gives the same arrays and is not ported).

Per index, as the reference: a column t < n_frames is log(|X[:, :, t]| +
1e-3), a column past the recording's frames log(min |X| + 1e-3); an eval
waveform is cut or zero-padded to max_len_time.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from neraf_tpu_torch.data.dataparsers import (
    AudioParserOutputs,
    parse_raf,
    parse_soundspaces,
)
from neraf_tpu_torch.data.loader import audio_arrays
from neraf_tpu_torch.dsp.resample import resample_poly
from neraf_tpu_torch.dsp.stft import stft_magnitude
from neraf_tpu_torch.utils.wav import read_wav


@dataclasses.dataclass
class AudioSliceDataset:
    """A fully-materialised split: poses + log-mag STFTs + eval waveforms."""

    outputs: AudioParserOutputs
    log_stft: np.ndarray  # (N, C, F, max_len) log magnitudes
    waveforms: np.ndarray | None  # (N, C, max_len_time) GT waveforms (eval splits)
    max_len: int
    fs: int
    hop_len: int

    @property
    def num_recordings(self) -> int:
        return self.log_stft.shape[0]

    def __len__(self) -> int:
        return self.num_recordings * self.max_len

    def slice_arrays(self, device="cuda") -> dict:
        """The batch sampler's arrays (data/loader.py::audio_arrays): poses
        (N, 3) x 3 and log_stft (N, C, F, T), float32 on `device`."""
        o = self.outputs
        return audio_arrays({"mic_pose": o.microphone_poses,
                             "source_pose": o.source_poses,
                             "rot": o.rotations, "log_stft": self.log_stft},
                            device)


def _pack_log_stft(mag: np.ndarray, max_len: int) -> np.ndarray:
    """(C, F, n_frames) magnitudes -> (C, F, max_len) log, min-padded."""
    C, F, T = mag.shape
    out = np.empty((C, F, max_len), dtype=np.float32)
    usable = min(T, max_len)
    out[:, :, :usable] = np.log(mag[:, :, :usable] + 1e-3)
    if usable < max_len:
        out[:, :, usable:] = np.log(mag.min() + 1e-3)
    return out


def _fit_waveform(wav: np.ndarray, max_len_time: int) -> np.ndarray:
    if wav.shape[1] >= max_len_time:
        return wav[:, :max_len_time]
    return np.pad(wav, ((0, 0), (0, max_len_time - wav.shape[1])), "constant")


def load_raf_dataset(
    data_dir: str | Path,
    split: str = "train",
    fs: int = 48000,
) -> AudioSliceDataset:
    """A RAF split: the STFT of data/<name>/rir.wav (48 kHz, first channel,
    cut to 0.32 s): n_fft 1024, win 512, hop 256 -> 513 bins, 60 frames.
    Eval splits keep the waveforms."""
    data_dir = Path(data_dir)
    if fs == 48000:
        n_fft, win_length, hop_len = 1024, 512, 256
    elif fs == 16000:
        n_fft, win_length, hop_len = 512, 256, 128
    else:
        raise ValueError("Sample rate not supported")

    outputs = parse_raf(data_dir, split)
    max_len_time = int(0.32 * fs)
    max_len = max_len_time // hop_len
    with_waveforms = split != "train"

    logs, wavs = [], []
    for name in outputs.audio_filenames:
        sr, wav = read_wav(data_dir / "data" / str(name) / "rir.wav")
        if sr != 48000:
            raise ValueError("Loaded sample rate should be 48kHz")
        if wav.ndim > 1:
            wav = wav[:, 0]
        wav = wav[:max_len_time]
        mag = stft_magnitude(torch.from_numpy(np.ascontiguousarray(wav)),
                             n_fft=n_fft, hop_length=hop_len,
                             win_length=win_length).numpy()[None]
        logs.append(_pack_log_stft(mag, max_len))
        if with_waveforms:
            wavs.append(_fit_waveform(wav[None], max_len_time))

    return AudioSliceDataset(
        outputs=outputs,
        log_stft=np.stack(logs) if logs else np.zeros((0, 1, n_fft // 2 + 1, max_len), np.float32),
        waveforms=np.stack(wavs) if wavs else None,
        max_len=max_len,
        fs=fs,
        hop_len=hop_len,
    )


def load_soundspaces_dataset(
    data_dir: str | Path,
    split: str = "train",
    fs: int = 22050,
    max_len: int = 78,
    hop_len: int = 128,
) -> AudioSliceDataset:
    """A SoundSpaces split from its precomputed magnitude .npy files. Eval
    splits keep the GT waveforms: the 44.1 kHz wavs clipped to [-1, 1],
    resampled to fs (dsp/resample.py's Kaiser filter) and cut or
    zero-padded to max_len * hop_len samples."""
    data_dir = Path(data_dir)
    outputs = parse_soundspaces(data_dir, split)
    max_len_time = max_len * hop_len
    with_waveforms = split != "train"

    logs, wavs = [], []
    for name in outputs.audio_filenames:
        mag = np.load(data_dir / "binaural_magnitudes_sr22050" / f"{name}.npy")  # (C, F, T)
        logs.append(_pack_log_stft(mag.astype(np.float32), max_len))
        if with_waveforms:
            _, wav = read_wav(data_dir / "binaural_rirs" / f"{name}.wav")
            wav = np.clip(wav, -1.0, 1.0).T  # (C, T)
            if wav.shape[1] == 0:
                wav = np.zeros((2, int(fs * 0.5)), np.float32)
            if fs != 44100:
                wav = resample_poly(np.ascontiguousarray(wav, np.float32),
                                    fs, 44100).numpy()
            wavs.append(_fit_waveform(wav, max_len_time))

    F = logs[0].shape[1] if logs else 257
    C = logs[0].shape[0] if logs else 2
    return AudioSliceDataset(
        outputs=outputs,
        log_stft=np.stack(logs) if logs else np.zeros((0, C, F, max_len), np.float32),
        waveforms=np.stack(wavs) if wavs else None,
        max_len=max_len,
        fs=fs,
        hop_len=hop_len,
    )
