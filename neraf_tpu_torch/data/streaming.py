"""The audio data path's decision (counterpart of
neraf_tpu/data/streaming.py:40-78): stream the split's log-STFT from host
memory, or hold the whole split on the device. Only the decision is
ported; the streaming sampler is ROADMAP queue 1 item 7, and the CLI
refuses a run that the decision would stream."""

from __future__ import annotations

import numpy as np


def split_device_bytes(log_stft) -> int:
    """Device bytes the device-resident path would commit for this split."""
    return int(np.prod(log_stft.shape)) * log_stft.dtype.itemsize


def should_stream(audio_cfg, dataset) -> bool:
    """"on" / "off" / "auto": auto streams when the split's log-STFT
    exceeds stream_threshold_gb (the device also holds the weights, Adam
    states, the grid and the ResNet's activations)."""
    mode = audio_cfg.streaming
    if mode == "on":
        return True
    if mode == "off":
        return False
    threshold = float(audio_cfg.stream_threshold_gb)
    return split_device_bytes(dataset.log_stft) > threshold * 2**30
