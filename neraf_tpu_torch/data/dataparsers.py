"""Audio dataparsers (counterpart of neraf_tpu/data/dataparsers.py): RAF,
SoundSpaces and the trajectory-inference poses, numpy only.

- RAF: the split from metadata/data-split.json; per recording the mic xyz
  from data/<name>/rx_pos.txt and the source quaternion (xyzw) and xyz
  from tx_pos.txt; the source's yaw (euler 'yxz', whole degrees) as the
  direction cosine [cos, 0, sin] mapped to [0, 1].
- SoundSpaces: grid points from metadata/points.txt remapped to
  [x, z, -y] (up becomes the second axis); the split from
  metadata_AudioNeRF/split.json; file names "{rot}/{rx}_{tx}".
- inference (the AVN_RENDER_POSES environment variable): a .npy dict for
  RAF, a Habitat .pkl trajectory for SoundSpaces.

The audio AABB is the mic poses' min/max with a 1 m margin.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
from pathlib import Path

import numpy as np
from scipy.spatial.transform import Rotation


@dataclasses.dataclass
class AudioParserOutputs:
    """Parsed split: filenames, poses, orientation cosines, scene AABB."""

    audio_filenames: list
    microphone_poses: np.ndarray  # (N, 3)
    source_poses: np.ndarray  # (N, 3)
    rotations: np.ndarray  # (N, 3) direction cosines in [0, 1]
    aabb: np.ndarray  # (2, 3)


def _aabb_from_mic_poses(mic_poses: np.ndarray) -> np.ndarray:
    aabb = np.array([mic_poses.min(axis=0), mic_poses.max(axis=0)], dtype=np.float64)
    aabb[0] -= 1.0
    aabb[1] += 1.0
    return aabb


def _yaw_to_cosine(yaw_deg: float) -> np.ndarray:
    """Angle around the up axis -> [cos, 0, sin] direction cosine in [0, 1]."""
    rad = np.deg2rad(yaw_deg)
    rot = np.array([np.cos(rad), 0.0, np.sin(rad)])
    return (rot + 1.0) / 2.0


def _outputs(files, mic_poses, source_poses, rots) -> AudioParserOutputs:
    mic_poses = np.asarray(mic_poses, dtype=np.float64)
    return AudioParserOutputs(files, mic_poses,
                              np.asarray(source_poses, dtype=np.float64),
                              np.asarray(rots, dtype=np.float64),
                              _aabb_from_mic_poses(mic_poses))


def parse_raf(data_dir: str | Path, split: str = "train") -> AudioParserOutputs:
    """Parse a RAF scene directory."""
    data_dir = Path(data_dir)
    if split == "inference":
        return parse_inference_poses_raf(os.environ["AVN_RENDER_POSES"])

    with open(data_dir / "metadata" / "data-split.json") as f:
        split_dict = json.load(f)
    key = {"train": "train", "val": "validation"}.get(split, "test")
    files = split_dict[key][0]

    mic_poses, source_poses, rots = [], [], []
    for name in files:
        rx = np.loadtxt(data_dir / "data" / name / "rx_pos.txt", delimiter=",", ndmin=2)[0]
        tx = np.loadtxt(data_dir / "data" / name / "tx_pos.txt", delimiter=",", ndmin=2)[0]
        yaw = np.round(Rotation.from_quat(tx[:4]).as_euler("yxz", degrees=True)[0],
                       decimals=0)
        rots.append(_yaw_to_cosine(yaw))
        mic_poses.append(rx[:3])
        source_poses.append(tx[4:7])
    return _outputs(files, mic_poses, source_poses, rots)


def parse_soundspaces(data_dir: str | Path, split: str = "train") -> AudioParserOutputs:
    """Parse a SoundSpaces scene directory."""
    data_dir = Path(data_dir)
    with open(data_dir / "metadata" / "points.txt") as f:
        lines = f.readlines()
    positions = {}
    for row in (x.strip().split("\t") for x in lines):
        vals = [float(v) for v in row[1:]]
        positions[row[0]] = [vals[0], vals[2], -vals[1]]  # up is second axis

    if split == "inference":
        return parse_inference_poses_soundspaces(os.environ["AVN_RENDER_POSES"])

    with open(data_dir / "metadata_AudioNeRF" / "split.json") as f:
        split_dict = json.load(f)
    files = split_dict["train"] if split == "train" else split_dict["test"]

    mic_poses, source_poses, rots = [], [], []
    for name in files:
        rot_str, r_s = name.split("/")
        rx_id, tx_id = r_s.split("_")
        mic_poses.append(positions[rx_id][:3])
        source_poses.append(positions[tx_id][:3])
        rots.append(_yaw_to_cosine(float(int(rot_str))))
    return _outputs(files, mic_poses, source_poses, rots)


def parse_inference_poses_raf(path: str) -> AudioParserOutputs:
    """RAF trajectory poses from a .npy dict (mic_poses (N, 3), one
    source_poses (3,) and rots (3,) for all)."""
    data = np.load(path, allow_pickle=True).item()
    mic_poses = np.asarray(data["mic_poses"], dtype=np.float64)
    n = mic_poses.shape[0]
    source_poses = np.repeat(np.asarray(data["source_poses"], dtype=np.float64)[None, :], n, axis=0)
    rots = np.repeat(np.asarray(data["rots"], dtype=np.float64)[None, :], n, axis=0)
    return _outputs(list(range(n)), mic_poses, source_poses, rots)


def parse_inference_poses_soundspaces(path: str) -> AudioParserOutputs:
    """SoundSpaces trajectory poses from a Habitat .pkl: the yaw from the
    quaternion (euler 'yzx', negative angles offset by 360), the mic at the
    source's height."""
    with open(path, "rb") as f:
        eval_data = pickle.load(f)["scene_obs"]

    mic_poses, source_poses, rots = [], [], []
    for v in eval_data:
        pose = np.asarray(v["pose"], dtype=np.float64).copy()
        yaw = Rotation.from_quat(v["quat"]).as_euler("yzx", degrees=True)[0]
        if yaw < 0:  # offset between Habitat and SoundSpaces conventions
            yaw = 360 + yaw
        rots.append(_yaw_to_cosine(yaw % 360))
        source_pose = np.asarray(v["source"][:3], dtype=np.float64)
        pose[1] = source_pose[1]  # training used a fixed mic height
        mic_poses.append(pose[:3])
        source_poses.append(source_pose)
    return _outputs(list(range(len(eval_data))), mic_poses, source_poses, rots)
