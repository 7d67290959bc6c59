"""Auralization: a predicted RIR convolved with dry audio (counterpart of
neraf_tpu/viz/auralization.py).

The reference's viewer auralization flow (NeRAF_model.py:221-267, with its
undefined-variable bug at :264 fixed): log-magnitudes -> magnitudes ->
Griffin-Lim (the CUDA kernel on a card) -> the RIR waveform; the dry input
truncated to 5 s, stereo averaged to mono, one FFT convolution per RIR
channel. Both run on the RIR's device and return tensors there.
"""

from __future__ import annotations

import torch

from neraf_tpu_torch.dsp.filters import fft_convolve
from neraf_tpu_torch.dsp.griffin_lim import griffin_lim
from neraf_tpu_torch.dsp.stft import log_to_magnitude


def rir_from_log_stft(log_stft: torch.Tensor, *, n_fft: int, hop_len: int,
                      win_len: int, n_iter: int = 32,
                      init_angles: torch.Tensor | None = None,
                      generator: torch.Generator | None = None) -> torch.Tensor:
    """(C, F, T) predicted log-magnitudes -> (C, L) f32 RIR waveform in
    [-1, 1], on log_stft's device. The Griffin-Lim start is `init_angles`
    (unit phasors), else drawn from `generator` (a fresh one seeded 0 when
    neither is given), as dsp/griffin_lim.py draws it."""
    mag = log_to_magnitude(log_stft.float())
    wav = griffin_lim(mag, n_fft=n_fft, hop_length=hop_len, win_length=win_len,
                      n_iter=n_iter, init_angles=init_angles,
                      generator=generator)
    return wav.clamp(-1.0, 1.0)


def auralize(input_wav, rir: torch.Tensor, fs: int,
             max_input_seconds: float = 5.0) -> torch.Tensor:
    """Dry audio ((L,) mono or (L, 2) stereo, array or tensor) convolved
    with a (C, Lr) RIR -> (C, L + Lr - 1) f32 wet audio on the RIR's
    device. The input is cut to max_input_seconds first."""
    rir = torch.as_tensor(rir, dtype=torch.float32)
    dry = torch.as_tensor(input_wav, dtype=torch.float32, device=rir.device)
    if dry.ndim == 2:  # stereo to mono
        dry = dry.mean(dim=-1)
    dry = dry[:int(max_input_seconds * fs)]
    return torch.stack([fft_convolve(dry, rir[c]) for c in range(rir.shape[0])])
