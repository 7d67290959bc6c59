"""The synthetic validation scenes (counterparts of
scripts/validate_learning.py:28-79 and scripts/validate_joint.py:27-62):
nothing is downloaded, and the same numpy seed gives the same poses,
waveforms and images as the reference's builders.

- synth_scene: a room whose RIRs depend smoothly on the geometry, as
  exponentially decaying noise with rt60 = 0.15 + 0.06 d, a direct-path
  delay and 1 / (1 + d) attenuation for a mic at distance d from one
  source; binaural, SoundSpaces' STFT (n_fft 512, hop 128, 257 bins).
- make_cameras: orbit cameras looking at the origin, and the analytic
  render of a coloured sphere of radius 0.5 on a grey background.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from neraf_tpu_torch.data.dataparsers import AudioParserOutputs
from neraf_tpu_torch.data.datasets import AudioSliceDataset
from neraf_tpu_torch.dsp.stft import stft_magnitude


def synth_scene(n_rec: int, fs: int = 22050, max_len: int = 60,
                seed: int = 0) -> AudioSliceDataset:
    """Poses + log-STFTs + GT waveforms (max_len * 128 samples) of n_rec
    recordings of a synthetic room."""
    rng = np.random.default_rng(seed)
    hop, n_fft = 128, 512
    L = max_len * hop

    mics = rng.uniform(-2.0, 2.0, (n_rec, 3))
    mics[:, 1] = 1.5  # fixed height, like the datasets
    src = np.array([0.0, 1.5, 0.0])
    rots = np.tile((np.array([1.0, 0.0, 0.0]) + 1) / 2, (n_rec, 1))

    logs, wavs = [], []
    t = np.arange(L) / fs
    for i in range(n_rec):
        d = np.linalg.norm(mics[i] - src)
        rt60 = 0.15 + 0.06 * d  # decay grows with distance
        tau = rt60 / np.log(1000.0)
        delay = int(d / 343.0 * fs)
        env = np.exp(-np.maximum(t - delay / fs, 0) / tau)
        env[:delay] = 0.0
        h = rng.standard_normal((2, L)).astype(np.float32) * env / (1.0 + d)
        mag = stft_magnitude(torch.as_tensor(h), n_fft=n_fft,
                             hop_length=hop).numpy()
        mag = mag[:, :, :max_len]
        logs.append(np.log(mag + 1e-3).astype(np.float32))
        wavs.append(h[:, :L])

    aabb = np.array([mics.min(0) - 1, mics.max(0) + 1])
    outputs = AudioParserOutputs(
        audio_filenames=[f"r{i}" for i in range(n_rec)],
        microphone_poses=mics,
        source_poses=np.tile(src, (n_rec, 1)),
        rotations=rots,
        aabb=aabb,
    )
    return AudioSliceDataset(outputs=outputs, log_stft=np.stack(logs),
                             waveforms=np.stack(wavs), max_len=max_len, fs=fs,
                             hop_len=hop)


def make_cameras(n_cams: int, radius: float = 2.0, size: int = 64):
    """n_cams orbit cameras (the CameraSet fields, for
    data/vision_data.py::camera_arrays) and their (n_cams, size, size, 3)
    analytic sphere images."""
    c2ws, images = [], []
    focal = 1.2 * size
    for i in range(n_cams):
        ang = 2 * np.pi * i / n_cams
        pos = np.array([radius * np.cos(ang), radius * np.sin(ang), 0.6])
        forward = -pos / np.linalg.norm(pos)
        up0 = np.array([0.0, 0.0, 1.0])
        right = np.cross(forward, up0)
        right /= np.linalg.norm(right)
        up = np.cross(right, forward)
        c2w = np.zeros((3, 4), np.float32)
        c2w[:, 0], c2w[:, 1], c2w[:, 2], c2w[:, 3] = right, up, -forward, pos
        c2ws.append(c2w)

        ys, xs = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
        x = (xs + 0.5 - size / 2) / focal
        y = (ys + 0.5 - size / 2) / focal
        dirs = np.stack([x, -y, -np.ones_like(x)], -1)
        dirs = dirs @ c2w[:, :3].T
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        oc = pos
        b = 2 * dirs @ oc
        c = oc @ oc - 0.5**2
        hit = b**2 - 4 * c > 0
        img = np.full((size, size, 3), 0.7, np.float32)
        img[hit] = [0.85, 0.2, 0.15]
        images.append(img)

    full = lambda v: np.full((n_cams,), v, np.float32)
    cams = SimpleNamespace(c2w=np.stack(c2ws), fx=full(focal), fy=full(focal),
                           cx=full(size / 2.0), cy=full(size / 2.0),
                           distortion=np.zeros((n_cams, 6), np.float32))
    return cams, np.stack(images)
