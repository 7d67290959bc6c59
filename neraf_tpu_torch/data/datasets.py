"""A materialised STFT-slice split (counterpart of
neraf_tpu/data/datasets.py): poses, every recording's full log-magnitude
STFT (N, C, F, max_len) and the eval waveforms, in host memory;
`slice_arrays` puts the sampler's arrays on a device. The loaders read a
RAF or a SoundSpaces scene from disk, through the native C++ ingest
(native/, as the JAX loaders do) unless NERAF_NATIVE=0, else through the
Python path (utils/wav.py, dsp/stft.py, dsp/resample.py on the host); the
two give the same arrays to float rounding.

Per index, as the reference: a column t < n_frames is log(|X[:, :, t]| +
1e-3), a column past the recording's frames log(min |X| + 1e-3); an eval
waveform is cut or zero-padded to max_len_time.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from neraf_tpu_torch import native
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


def _raf_python(path: Path, max_len_time: int, stft: tuple, max_len: int):
    """One RAF wav through the Python path -> (log STFT (1, F, max_len),
    waveform (1, n) cut to max_len_time). The STFT runs in float64, as the
    native library's FFT does, so the two paths differ by the magnitudes'
    float32 rounding only (in float32 the smallest bins, which set the
    min-padding log(min + 1e-3), move by ~1e-7: 1e-4 in the log)."""
    sr, wav = read_wav(path)
    if sr != 48000:
        raise ValueError("Loaded sample rate should be 48kHz")
    if wav.ndim > 1:
        wav = wav[:, 0]
    wav = wav[:max_len_time]
    n_fft, win_length, hop_len = stft
    mag = stft_magnitude(torch.from_numpy(wav.astype(np.float64)),
                         n_fft=n_fft, hop_length=hop_len,
                         win_length=win_length).numpy()[None]
    return _pack_log_stft(mag.astype(np.float32), max_len), wav[None]


def _raf_native(paths: list, max_len_time: int, stft: tuple, max_len: int,
                with_waveforms: bool) -> dict:
    """The RAF wavs the native library takes, through process_rir_batch (no
    clip, first channel, cut to max_len_time) -> {index: (log STFT,
    waveform or None)}; a wav whose header it refuses or whose samples it
    cannot decode is counted (native.fallbacks()) and left to the Python
    path."""
    infos = {}
    for i, p in enumerate(paths):
        try:
            infos[i] = native.wav_info(p)
        except IOError as e:
            native.count_fallback(p, e)
    if any(sr != 48000 for sr, _, _ in infos.values()):
        raise ValueError("Loaded sample rate should be 48kHz")
    good = sorted(infos)
    if not good:
        return {}
    n_fft, win_length, hop_len = stft
    try:
        mags, chans = native.process_rir_batch(
            [paths[i] for i in good], target_fs=0, n_fft=n_fft, hop=hop_len,
            win=win_length, max_samples=max_len_time, max_channels=1,
            n_frames=max_len + 1, clip=False)
    except native.BatchError as e:
        mags, chans = e.mags, e.channels
    out = {}
    for mag, c, i in zip(mags, chans, good):
        if c == 0:
            native.count_fallback(paths[i], IOError("samples not decoded"))
            continue
        frames = infos[i][1]
        log = _pack_log_stft(mag[:, :, :1 + min(frames, max_len_time) // hop_len],
                             max_len)
        wav = None
        if with_waveforms:
            try:
                _, wav = native.read_wav(paths[i])
            except IOError as e:
                native.count_fallback(paths[i], e)
                continue
            if wav.ndim > 1:
                wav = wav[:, 0]
            wav = wav[None, :max_len_time]
        out[i] = (log, wav)
    return out


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
        stft = (1024, 512, 256)
    elif fs == 16000:
        stft = (512, 256, 128)
    else:
        raise ValueError("Sample rate not supported")
    n_fft, _, hop_len = stft

    outputs = parse_raf(data_dir, split)
    max_len_time = int(0.32 * fs)
    max_len = max_len_time // hop_len
    with_waveforms = split != "train"

    paths = [data_dir / "data" / str(n) / "rir.wav"
             for n in outputs.audio_filenames]
    done = (_raf_native(paths, max_len_time, stft, max_len, with_waveforms)
            if paths and native.available() else {})
    logs, wavs = [], []
    for i, path in enumerate(paths):
        log, wav = done[i] if i in done else _raf_python(
            path, max_len_time, stft, max_len)
        logs.append(log)
        if with_waveforms:
            wavs.append(_fit_waveform(wav, max_len_time))

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
    resampled to fs (the Kaiser filter of dsp/resample.py, or its native
    twin) and cut or zero-padded to max_len * hop_len samples."""
    data_dir = Path(data_dir)
    outputs = parse_soundspaces(data_dir, split)
    max_len_time = max_len * hop_len
    with_waveforms = split != "train"
    use_native = with_waveforms and fs != 44100 and native.available()

    logs, wavs = [], []
    for name in outputs.audio_filenames:
        mag = np.load(data_dir / "binaural_magnitudes_sr22050" / f"{name}.npy")  # (C, F, T)
        logs.append(_pack_log_stft(mag.astype(np.float32), max_len))
        if with_waveforms:
            _, wav = read_wav(data_dir / "binaural_rirs" / f"{name}.wav")
            wav = np.clip(wav, -1.0, 1.0).T  # (C, T)
            if wav.shape[1] == 0:
                wav = np.zeros((2, int(fs * 0.5)), np.float32)
            if use_native:
                wav = native.resample_poly(wav, fs, 44100)
            elif fs != 44100:
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
