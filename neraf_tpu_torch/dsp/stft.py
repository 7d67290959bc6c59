"""STFT / iSTFT with the reference's conventions, on torch.stft / torch.istft.

Counterpart of neraf_tpu/dsp/stft.py: center=True, reflect padding, a Hann
window of ``win_length`` zero-padded symmetrically to ``n_fft``, onesided,
unnormalised. Spectrograms are (..., F, T), F = n_fft // 2 + 1.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from neraf_tpu_torch.utils.profiling import span


def _hann_np(win_length: int) -> np.ndarray:
    n = np.arange(win_length)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))


def hann_window(win_length: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hann window (matches torch.hann_window(periodic=True))."""
    return torch.as_tensor(_hann_np(win_length), dtype=dtype, device=device)


def _padded_window_np(n_fft: int, win_length: int) -> np.ndarray:
    w = _hann_np(win_length)
    if win_length < n_fft:
        left = (n_fft - win_length) // 2
        w = np.pad(w, (left, n_fft - win_length - left))
    return w


def _padded_window(n_fft: int, win_length: int, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """Hann(win_length) zero-padded symmetrically to n_fft (torch.stft rule)."""
    return torch.as_tensor(_padded_window_np(n_fft, win_length), dtype=dtype,
                           device=device)


def stft_complex(x: torch.Tensor, n_fft: int, hop_length: int,
                 win_length: int | None = None) -> torch.Tensor:
    """(..., L) real signal -> (..., F, n_frames) complex spectrogram."""
    win_length = n_fft if win_length is None else win_length
    window = _padded_window(n_fft, win_length, x.dtype, x.device)
    spec = torch.stft(x.reshape(-1, x.shape[-1]), n_fft, hop_length,
                      win_length=n_fft, window=window, center=True,
                      pad_mode="reflect", normalized=False, onesided=True,
                      return_complex=True)
    return spec.reshape(*x.shape[:-1], *spec.shape[-2:])


def stft_magnitude(x: torch.Tensor, n_fft: int, hop_length: int,
                   win_length: int | None = None) -> torch.Tensor:
    """|stft|, the reference's Spectrogram(power=None) + abs."""
    return stft_complex(x, n_fft, hop_length, win_length).abs()


def istft(spec: torch.Tensor, n_fft: int, hop_length: int,
          win_length: int | None = None, length: int | None = None) -> torch.Tensor:
    """(..., F, n_frames) complex spectrogram -> (..., length) real signal.

    Overlap-add with window-sum-of-squares normalisation; `length` defaults
    to (n_frames - 1) * hop.
    """
    win_length = n_fft if win_length is None else win_length
    n_frames = spec.shape[-1]
    length = hop_length * (n_frames - 1) if length is None else length
    window = _padded_window(n_fft, win_length, torch.float32, spec.device)
    # irfft drops the imaginary parts of the DC and Nyquist bins (as the JAX
    # package's does); cuFFT's batched C2R at n_fft 1024 does not, so drop
    # them here and the result no longer depends on the device
    spec = spec.clone()
    spec[..., 0, :].imag.zero_()
    spec[..., n_fft // 2, :].imag.zero_()
    out = torch.istft(spec.reshape(-1, *spec.shape[-2:]), n_fft, hop_length,
                      win_length=n_fft, window=window, center=True,
                      normalized=False, onesided=True, length=length)
    return out.reshape(*spec.shape[:-2], length)


def log_magnitude(mag: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """log(|X| + 1e-3), the reference's log transform."""
    return torch.log(mag + eps)


def log_to_magnitude(log_mag: torch.Tensor, eps: float = 1e-3,
                     max_val: float = 1e4) -> torch.Tensor:
    """clip(exp(x) - 1e-3, 0, 1e4), the inverse log transform (span
    rir.magnitude)."""
    with span("rir.magnitude"):
        return torch.clamp(torch.exp(log_mag) - eps, 0.0, max_val)


@functools.lru_cache(maxsize=32)
def _wsq_np(n_fft: int, hop_length: int, win_length: int, n_frames: int,
            length: int) -> tuple:
    """Window sum of squares over the trimmed signal, clamped at 1e-11."""
    w2 = _padded_window_np(n_fft, win_length).astype(np.float64) ** 2
    expected = n_fft + hop_length * (n_frames - 1)
    wsq = np.zeros(expected)
    for f in range(n_frames):
        wsq[f * hop_length : f * hop_length + n_fft] += w2
    pad = n_fft // 2
    return tuple(np.maximum(wsq[pad : pad + length], 1e-11).tolist())
