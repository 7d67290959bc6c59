"""A materialised STFT-slice split (counterpart of
neraf_tpu/data/datasets.py:34-80): poses, every recording's full
log-magnitude STFT (N, C, F, max_len) and the eval waveforms, in host
memory; `slice_arrays` puts the sampler's arrays on a device. The loaders
come with the data layer's slice.

Per index, as the reference: a column t < n_frames is log(|X[:, :, t]| +
1e-3), a column past the recording's frames log(min |X| + 1e-3); an eval
waveform is cut or zero-padded to max_len_time.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from neraf_tpu_torch.data.dataparsers import AudioParserOutputs
from neraf_tpu_torch.data.loader import audio_arrays


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
