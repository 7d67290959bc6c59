"""STFT-slice batches (counterpart of neraf_tpu/data/loader.py): a batch
is B (recording, time bin) pairs drawn uniformly over the split, with the
poses and the STFT column of each gathered on the device, from the whole
split on the device or from a batch that data/streaming.py gathered on the
host (resolve_audio_batch).
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


def num_recordings(audio_in: dict) -> int:
    """N of either input structure: its (N, 3) pose tables."""
    return audio_in["mic_pose"].shape[0]


def resolve_audio_batch(audio_in: dict, rec: torch.Tensor,
                        t: torch.Tensor) -> dict:
    """Either input structure -> the batch gather_audio_batch makes:
    - {"log_stft" (N, C, F, T), poses (N, 3)}: the device-resident split,
      gathered at (rec, t);
    - {"data" (B, C, F), "audio_idx", "time_query" (B,), poses (N, 3)}: a
      streamed batch (data/streaming.py), whose own indices are used and
      (rec, t) ignored; the poses are gathered on the device and `data`
      (bfloat16 when streamed so) upcast to float32.
    A dict with neither "log_stft" nor "data" raises KeyError."""
    if "log_stft" in audio_in:
        return gather_audio_batch(audio_in, rec, t)
    if "data" not in audio_in:
        raise KeyError(f"an audio input holds 'log_stft' or 'data', not "
                       f"{sorted(audio_in)}")
    idx = audio_in["audio_idx"]
    return {
        "audio_idx": idx,
        "data": audio_in["data"].to(torch.float32),
        "time_query": audio_in["time_query"],
        "mic_pose": audio_in["mic_pose"][idx],
        "source_pose": audio_in["source_pose"][idx],
        "rot": audio_in["rot"][idx],
    }
