"""Biquad highpass, FFT convolution and Hilbert envelope (counterpart of
neraf_tpu/dsp/filters.py:18-96).

`highpass_biquad` takes a numpy array (the host estimators) or a torch
tensor (the batched device estimators). The host form is scipy's
`lfilter` with the normalised coefficients. The device form has no
per-sample loop: the FIR part is three shifted adds, and the AR part a
blocked linear recurrence (blocks of K samples). One matmul with the K x K
lower-triangular Toeplitz matrix of the AR impulse response gives every
block's response to its own input from a zero state; a loop over the L / K
blocks carries the two-sample state across block boundaries; one more
product adds each block's response to the state it was handed. It runs in
float64 whatever the input (the AR gain of a 200 Hz highpass at 48 kHz is
~1,400 at DC, and a float64 matmul leaves no TF32 question) and returns the
input's dtype.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.signal
import torch

_BLOCK = 128  # samples a block of the device recurrence


def _highpass_coeffs(sample_rate: float, cutoff_freq: float, q: float = 0.707):
    """Biquad highpass coefficients (RBJ audio-EQ cookbook, torchaudio's)."""
    w0 = 2.0 * math.pi * cutoff_freq / sample_rate
    alpha = math.sin(w0) / (2.0 * q)
    cos_w0 = math.cos(w0)
    b0 = (1.0 + cos_w0) / 2.0
    b1 = -(1.0 + cos_w0)
    b2 = (1.0 + cos_w0) / 2.0
    a0 = 1.0 + alpha
    a1 = -2.0 * cos_w0
    a2 = 1.0 - alpha
    return (b0 / a0, b1 / a0, b2 / a0), (a1 / a0, a2 / a0)


def _ar_run(a1: float, a2: float, K: int, y2: float, y1: float,
            x0: float) -> np.ndarray:
    """K outputs of y[t] = x[t] - a1 y[t-1] - a2 y[t-2], float64, for an
    input x0 at t = 0 only and the state y[-2] = y2, y[-1] = y1."""
    out = np.zeros(K)
    for t in range(K):
        out[t] = (x0 if t == 0 else 0.0) - a1 * y1 - a2 * y2
        y2, y1 = y1, out[t]
    return out


def _biquad_torch(x: torch.Tensor, b, a) -> torch.Tensor:
    K = _BLOCK
    b0, b1, b2 = b
    a1, a2 = a
    shape, dtype, L = x.shape, x.dtype, x.shape[-1]
    xd = x.reshape(-1, L).to(torch.float64)
    v = b0 * xd
    v[:, 1:] += b1 * xd[:, :-1]
    v[:, 2:] += b2 * xd[:, :-2]
    nb = -(-L // K)
    v = torch.nn.functional.pad(v, (0, nb * K - L)).reshape(-1, nb, K)
    # the impulse response, and the responses to y[-1] = 1 and y[-2] = 1
    h, g1, g2 = (torch.as_tensor(_ar_run(a1, a2, K, *init), device=x.device)
                 for init in ((0.0, 0.0, 1.0), (0.0, 1.0, 0.0),
                              (1.0, 0.0, 0.0)))
    idx = torch.arange(K, device=x.device)
    lag = idx[:, None] - idx[None, :]
    toeplitz = torch.where(lag >= 0, h[lag.clamp_min(0)], 0.0)  # (K, K)
    z = v @ toeplitz.T  # each block from a zero state
    # the state handed into block j: (y[jK - 1], y[jK - 2])
    s1 = torch.zeros((z.shape[0], nb), dtype=torch.float64, device=x.device)
    s2 = torch.zeros_like(s1)
    for j in range(1, nb):
        p1, p2 = s1[:, j - 1], s2[:, j - 1]
        s1[:, j] = z[:, j - 1, K - 1] + g1[K - 1] * p1 + g2[K - 1] * p2
        s2[:, j] = z[:, j - 1, K - 2] + g1[K - 2] * p1 + g2[K - 2] * p2
    y = z + torch.stack([s1, s2], dim=-1) @ torch.stack([g1, g2])
    return y.reshape(-1, nb * K)[:, :L].reshape(shape).to(dtype)


def highpass_biquad(x, sample_rate: float, cutoff_freq: float,
                    q: float = 0.707):
    """Highpass biquad along the last axis (torchaudio.functional's
    highpass_biquad): a numpy array through scipy's lfilter (float64), a
    torch tensor through the blocked recurrence (module docstring)."""
    (b0, b1, b2), (a1, a2) = _highpass_coeffs(sample_rate, cutoff_freq, q)
    if isinstance(x, torch.Tensor):
        return _biquad_torch(x, (b0, b1, b2), (a1, a2))
    return scipy.signal.lfilter([b0, b1, b2], [1.0, a1, a2],
                                np.asarray(x, np.float64), axis=-1)


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def fft_convolve(x: torch.Tensor, y: torch.Tensor,
                 mode: str = "full") -> torch.Tensor:
    """1-D FFT convolution along the last axis, broadcast over leading axes
    (scipy.signal.fftconvolve's values), in float32 on the tensors' device:
    "full" keeps all len(x) + len(y) - 1 samples, "same" the len(x) centred
    on x (any other mode is "full", as in the JAX package)."""
    n = x.shape[-1] + y.shape[-1] - 1
    nfft = _next_pow2(n)
    spec = torch.fft.rfft(x.float(), n=nfft) * torch.fft.rfft(y.float(), n=nfft)
    out = torch.fft.irfft(spec, n=nfft)[..., :n]
    if mode == "same":
        start = (y.shape[-1] - 1) // 2
        out = out[..., start:start + x.shape[-1]]
    return out


def hilbert_envelope(x: np.ndarray) -> np.ndarray:
    """|hilbert(x)|, the analytic signal's envelope along the last axis."""
    return np.abs(scipy.signal.hilbert(np.asarray(x), axis=-1))
