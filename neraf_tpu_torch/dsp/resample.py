"""Polyphase resampling (counterpart of neraf_tpu/dsp/resample.py): the
same Kaiser-windowed sinc lowpass, applied as a zero-stuffing strided
convolution. The data layer resamples SoundSpaces' 44.1 kHz RIR wavs to
22.05 kHz with it on the host, as the JAX loader does; data/preprocess.py
and the viewer's /auralize run it on the card."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _kaiser_sinc_kernel(up: int, down: int, num_zeros: int = 24, beta: float = 8.555) -> np.ndarray:
    """Lowpass windowed-sinc for rational resampling by up/down."""
    cutoff = 0.5 / max(up, down)
    half_len = num_zeros * max(up, down)
    n = np.arange(-half_len, half_len + 1)
    taps = 2 * cutoff * np.sinc(2 * cutoff * n)
    taps *= np.kaiser(len(n), beta)
    return (taps * up).astype(np.float32)


def resample_poly(x, up: int, down: int) -> torch.Tensor:
    """Resample the last axis of x (a tensor or array, (..., L)) by up/down
    -> (..., ceil(L * up / down)) float32, on x's device."""
    x = torch.as_tensor(x)
    g = math.gcd(up, down)
    up, down = up // g, down // g
    if up == 1 and down == 1:
        return x
    length = x.shape[-1]
    out_len = -(-length * up // down)  # ceil
    taps = torch.from_numpy(_kaiser_sinc_kernel(up, down)).to(x.device)
    half = (taps.shape[0] - 1) // 2
    lead = x.shape[:-1]
    xf = x.reshape(-1, 1, length).to(torch.float32)
    if up > 1:  # zero-stuff: the input dilated by up
        z = xf.new_zeros(xf.shape[0], 1, (length - 1) * up + 1)
        z[..., ::up] = xf
        xf = z
    # a correlation with the reversed taps is the convolution with the taps,
    # in float32 on a card too (cuDNN's TF32 off for the call)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv1d(F.pad(xf, (half, half + up - 1)), taps.flip(0)[None, None])
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    y = y[..., ::down][..., :out_len]
    return y.reshape(*lead, out_len)
