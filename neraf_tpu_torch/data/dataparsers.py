"""Parsed audio splits (counterpart of neraf_tpu/data/dataparsers.py:32-40).
The RAF and SoundSpaces parsers come with the data layer's slice."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class AudioParserOutputs:
    """Parsed split: filenames, poses, orientation cosines, scene AABB."""

    audio_filenames: list
    microphone_poses: np.ndarray  # (N, 3)
    source_poses: np.ndarray  # (N, 3)
    rotations: np.ndarray  # (N, 3) direction cosines in [0, 1]
    aabb: np.ndarray  # (2, 3)
