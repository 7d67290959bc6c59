"""Griffin-Lim phase recovery (counterpart of neraf_tpu/dsp/griffin_lim.py).

torchaudio's algorithm as the reference uses it: momentum 0.99 applied as
momentum / (1 + momentum), 32 iterations, random initial phase. The phase is
drawn from an explicit ``torch.Generator`` or passed in as unit phasors.

``griffin_lim`` dispatches by device: a CPU tensor runs ``griffin_lim_plain``,
a CUDA tensor the hand-written kernel (ops/cuda/griffin_lim.py). There is no
size threshold and no fallback.
"""

from __future__ import annotations

import math

import torch

from neraf_tpu_torch.dsp.stft import istft, stft_complex


def random_angles(shape, generator: torch.Generator | None = None,
                  device=None) -> torch.Tensor:
    """Unit phasors exp(i*phi), phi ~ uniform[0, 2*pi), as complex64.

    Drawn on the generator's device (a fresh generator seeded 0 when none is
    given) and moved to `device`.
    """
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    phase = torch.rand(shape, generator=generator, device=generator.device,
                       dtype=torch.float32) * (2 * math.pi)
    return torch.polar(torch.ones_like(phase), phase).to(device)


def griffin_lim_plain(
    mag: torch.Tensor,
    *,
    n_fft: int,
    hop_length: int,
    win_length: int | None = None,
    n_iter: int = 32,
    momentum: float = 0.99,
    length: int | None = None,
    init_angles: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """(..., F, T) magnitudes -> (..., length) waveform, with torch.stft/istft."""
    win_length = n_fft if win_length is None else win_length
    length = hop_length * (mag.shape[-1] - 1) if length is None else length
    mom = momentum / (1.0 + momentum)
    mag = mag.to(torch.float32)
    if init_angles is None:
        init_angles = random_angles(mag.shape, generator, mag.device)
    angles = init_angles.to(torch.complex64)

    tprev = torch.zeros_like(angles)
    for _ in range(n_iter):
        inverse = istft(mag * angles, n_fft, hop_length, win_length, length)
        rebuilt = stft_complex(inverse, n_fft, hop_length, win_length)
        new = rebuilt - mom * tprev
        angles = new / new.abs().clamp_min(1e-16)
        tprev = rebuilt
    return istft(mag * angles, n_fft, hop_length, win_length, length)


def griffin_lim(
    mag: torch.Tensor,
    *,
    n_fft: int,
    hop_length: int,
    win_length: int | None = None,
    n_iter: int = 32,
    momentum: float = 0.99,
    length: int | None = None,
    init_angles: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Recover a waveform: the CUDA kernel for a CUDA tensor, else plain."""
    from neraf_tpu_torch.ops.cuda.griffin_lim import griffin_lim_cuda

    mag = mag.to(torch.float32).contiguous()
    if init_angles is None:
        init_angles = random_angles(mag.shape, generator, mag.device)
    return griffin_lim_cuda(
        mag, init_angles.to(torch.complex64).contiguous(), n_fft=n_fft,
        hop_length=hop_length, win_length=win_length, n_iter=n_iter,
        momentum=momentum, length=length)
