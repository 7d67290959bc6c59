"""Spectral losses for acoustic-field training (counterpart of
neraf_tpu/metrics/losses.py:13-39, the reference's STFTLoss)."""

from __future__ import annotations

import torch


def spectral_convergence_loss(x_mag: torch.Tensor,
                              y_mag: torch.Tensor) -> torch.Tensor:
    """||y - x||_F / ||y||_F on magnitude spectrograms."""
    return torch.linalg.vector_norm(y_mag - x_mag) / torch.linalg.vector_norm(y_mag)


def log_stft_magnitude_loss(x_log: torch.Tensor, y_log: torch.Tensor,
                            loss_type: str = "l1") -> torch.Tensor:
    """L1 or MSE between log-magnitude spectrograms."""
    if loss_type == "l1":
        return torch.mean(torch.abs(y_log - x_log))
    if loss_type == "mse":
        return torch.mean((y_log - x_log) ** 2)
    raise ValueError(f"unknown loss_type {loss_type!r}")


def stft_loss(x_log: torch.Tensor, y_log: torch.Tensor,
              loss_type: str = "mse") -> dict:
    """Spectral convergence on magnitudes exp(x) - 1e-3, the magnitude term
    in log space."""
    x_mag = torch.exp(x_log) - 1e-3
    y_mag = torch.exp(y_log) - 1e-3
    return {
        "audio_sc_loss": spectral_convergence_loss(x_mag, y_mag),
        "audio_mag_loss": log_stft_magnitude_loss(x_log, y_log, loss_type),
    }
