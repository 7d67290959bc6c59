"""Trajectory audio-visual rendering (counterpart of
neraf_tpu/viz/trajectory.py, the reference's viz/video.ipynb).

The reference's video flow: a camera/mic trajectory is rendered to per-pose
STFTs (AVN_RENDER_POSES + the eval CLI), each STFT becomes an RIR through
Griffin-Lim, and the moving listener's track is dry audio convolved with the
time-varying RIRs under 50%-overlap Hann crossfades; ffmpeg muxes the
frames. Here:

- make_trajectory_poses / save_trajectory_npy: the pose file that
  `AVN_RENDER_POSES=poses.npy` feeds to the eval CLI (the RAF .npy dict,
  read by data/dataparsers.py::parse_inference_poses_raf);
- moving_listener_audio: the overlap-add time-varying convolution, one FFT
  convolution a hop on the RIRs' device;
- assemble_video_cmd: the ffmpeg command, as a string for the user to run.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from neraf_tpu_torch.dsp.filters import fft_convolve


def make_trajectory_poses(waypoints: np.ndarray, n_steps: int,
                          source_pose: np.ndarray, rot_deg: float = 0.0) -> dict:
    """Mic positions linearly interpolated along (K, 3) waypoints ->
    {'mic_poses': (n_steps, 3), 'source_poses': (3,), 'rots': (3,)}."""
    waypoints = np.asarray(waypoints, dtype=np.float64)
    k = waypoints.shape[0]
    seg = np.linspace(0, k - 1, n_steps)
    i0 = np.clip(np.floor(seg).astype(int), 0, k - 2)
    frac = (seg - i0)[:, None]
    mic = waypoints[i0] * (1 - frac) + waypoints[i0 + 1] * frac

    rad = np.deg2rad(rot_deg)
    rot = (np.array([np.cos(rad), 0.0, np.sin(rad)]) + 1.0) / 2.0
    return {
        "mic_poses": mic,
        "source_poses": np.asarray(source_pose, dtype=np.float64),
        "rots": rot,
    }


def save_trajectory_npy(poses: dict, path: str | Path) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path, poses, allow_pickle=True)
    return path


def moving_listener_audio(dry, rirs: torch.Tensor, fs: int,
                          frame_rate: float = 10.0) -> torch.Tensor:
    """Time-varying convolution with 50%-overlap Hann crossfades.

    The dry signal is cut into windows of 2 / frame_rate seconds hopped by
    1 / frame_rate; window i is convolved with trajectory step i's RIR and
    the wet windows are overlap-added (the reference video notebook's
    moving listener).

    Args:
        dry: (L,) mono dry signal (array or tensor).
        rirs: (N, C, Lr) per-step RIRs (N >= the hops used).
    Returns:
        (C, L_out) f32 wet audio on the RIRs' device.
    """
    rirs = torch.as_tensor(rirs, dtype=torch.float32)
    dry = torch.as_tensor(dry, dtype=torch.float32, device=rirs.device)
    n_steps, n_ch, lr = rirs.shape

    hop = int(fs / frame_rate)
    win = 2 * hop
    window = torch.as_tensor(np.hanning(win).astype(np.float32),
                             device=rirs.device)

    n_hops = min(n_steps, max(1, (len(dry) - win) // hop + 1))
    out = torch.zeros((n_ch, (n_hops - 1) * hop + win + lr - 1),
                      dtype=torch.float32, device=rirs.device)
    for i in range(n_hops):
        seg = dry[i * hop:i * hop + win]
        seg = torch.nn.functional.pad(seg, (0, win - seg.shape[0])) * window
        out[:, i * hop:i * hop + win + lr - 1] += fft_convolve(seg[None, :],
                                                               rirs[i])
    return out


def assemble_video_cmd(frames_glob: str, audio_wav: str, out_mp4: str,
                       frame_rate: float = 10.0) -> str:
    """The ffmpeg command that muxes rendered frames with the audio track."""
    return (f"ffmpeg -framerate {frame_rate} -pattern_type glob -i '{frames_glob}' "
            f"-i '{audio_wav}' -c:v libx264 -pix_fmt yuv420p -c:a aac -shortest {out_mp4}")
