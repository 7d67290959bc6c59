"""STFT-slice batches from a device-resident split (counterpart of
neraf_tpu/data/loader.py:18-48): a batch is B (recording, time bin) pairs
drawn uniformly over the split, with the poses and the STFT column of each
gathered on the device. The streaming form waits for the streaming slice.
"""

from __future__ import annotations

import torch


def audio_arrays(arrays: dict, device="cuda") -> dict:
    """mic_pose / source_pose / rot (N, 3) and log_stft (N, C, F, T) as
    float32 tensors on `device`."""
    return {k: torch.as_tensor(arrays[k], dtype=torch.float32, device=device)
            for k in ("mic_pose", "source_pose", "rot", "log_stft")}


def sample_audio_indices(n_rec: int, max_len: int, batch_size: int,
                         generator: torch.Generator, device=None):
    """(rec, t), each (B,), uniform over the n_rec x max_len slices."""
    idx = torch.randint(0, n_rec * max_len, (batch_size,), generator=generator,
                        device=device)
    return idx // max_len, idx % max_len


def gather_audio_batch(arrays: dict, rec: torch.Tensor,
                       t: torch.Tensor) -> dict:
    """The batch of explicit (recording, time bin) indices: data (B, C, F),
    time_query (B,) and the recordings' poses."""
    return {
        "audio_idx": rec,
        "data": arrays["log_stft"][rec, :, :, t],
        "time_query": t,
        "mic_pose": arrays["mic_pose"][rec],
        "source_pose": arrays["source_pose"][rec],
        "rot": arrays["rot"][rec],
    }


def sample_audio_batch(arrays: dict, batch_size: int, max_len: int,
                       generator: torch.Generator) -> dict:
    rec, t = sample_audio_indices(arrays["log_stft"].shape[0], max_len,
                                  batch_size, generator,
                                  arrays["log_stft"].device)
    return gather_audio_batch(arrays, rec, t)
