"""Spectral losses for acoustic-field training and the quick eval
(counterpart of neraf_tpu/metrics/losses.py: the reference's STFTLoss and
the SING spectral loss).

The training losses take the data mesh (parallel/sharding.py) of a step
whose batch is sharded over ranks, and then return the loss of the global
batch on every rank, as the JAX package's losses give it under its mesh:
the spectral convergence, a ratio of norms over the whole batch, from the
squared norms summed over ranks before the square roots (the mean of the
ranks' ratios is another loss), a mean as the ranks' sums over their
blocks, which may differ in size, over the global count
(parallel/sharding.py::global_mean). Both are differentiable through the
ranks' collectives."""

from __future__ import annotations

import torch

from neraf_tpu_torch.parallel.sharding import all_reduce_sum, global_mean


def spectral_convergence_loss(x_mag: torch.Tensor, y_mag: torch.Tensor,
                              mesh=None) -> torch.Tensor:
    """||y - x||_F / ||y||_F on magnitude spectrograms, over the global
    batch under a mesh: the square roots of the summed squares (on the
    CPU, torch.linalg.vector_norm of a float32 million-element batch is
    1.6e-5 off in relative terms, the summed squares 1.5e-8, jnp's norm
    2.5e-8)."""
    sq = all_reduce_sum(torch.stack([((y_mag - x_mag) ** 2).sum(),
                                     (y_mag ** 2).sum()]), mesh)
    return torch.sqrt(sq[0]) / torch.sqrt(sq[1])


def log_stft_magnitude_loss(x_log: torch.Tensor, y_log: torch.Tensor,
                            loss_type: str = "l1", mesh=None) -> torch.Tensor:
    """L1 or MSE between log-magnitude spectrograms (the global batch's
    under a mesh)."""
    if loss_type == "l1":
        return global_mean(torch.mean(torch.abs(y_log - x_log)), mesh,
                           x_log.numel())
    if loss_type == "mse":
        return global_mean(torch.mean((y_log - x_log) ** 2), mesh,
                           x_log.numel())
    raise ValueError(f"unknown loss_type {loss_type!r}")


def stft_loss(x_log: torch.Tensor, y_log: torch.Tensor,
              loss_type: str = "mse", mesh=None) -> dict:
    """Spectral convergence on magnitudes exp(x) - 1e-3, the magnitude term
    in log space (the global batch's under a mesh)."""
    x_mag = torch.exp(x_log) - 1e-3
    y_mag = torch.exp(y_log) - 1e-3
    return {
        "audio_sc_loss": spectral_convergence_loss(x_mag, y_mag, mesh),
        "audio_mag_loss": log_stft_magnitude_loss(x_log, y_log, loss_type,
                                                  mesh),
    }


def spectral_loss(a: torch.Tensor, b: torch.Tensor, *, base: str = "l1",
                  epsilon: float = 1.0, db: bool = False,
                  stft_input_type: str = "mag") -> torch.Tensor:
    """SING spectral loss (counterpart of neraf_tpu/metrics/losses.py:42):
    L1 (base "l1") or MSE between log spectrograms, log(eps + X) for
    magnitudes (10 log10 in dB mode), the input itself for "log mag"."""
    def _log_spec(s):
        if stft_input_type == "log mag":
            return s
        if db:
            return 10.0 * torch.log10(epsilon + s)
        return torch.log(epsilon + s)

    sa, sb = _log_spec(a), _log_spec(b)
    if base == "l1":
        return torch.mean(torch.abs(sa - sb))
    return torch.mean((sa - sb) ** 2)
