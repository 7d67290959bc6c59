"""Loudness maps: a dense microphone grid's RIRs -> a top-down RMS heatmap
(counterpart of neraf_tpu/viz/loudness.py, the reference's
viz/loudness_maps.ipynb).

A regular grid of microphones at one height spans the audio box's x/z
extent; every cell's RIR is rendered in one batched sweep on the device and
reduced to its RMS loudness in dB there. Only the (res, res) map comes back
to the host; loudness_image colours it for the CLI's PNG.
"""

from __future__ import annotations

import numpy as np
import torch

from neraf_tpu_torch.dsp.stft import log_to_magnitude
from neraf_tpu_torch.utils.png import resize_nearest
from neraf_tpu_torch.viz.panels import _viridis


def render_loudness_grid(render_rirs_fn, source_pose: np.ndarray,
                         rot: np.ndarray, aabb: np.ndarray, height: float,
                         resolution: int = 32) -> dict:
    """RIRs on a (resolution x resolution) mic grid at a fixed height.

    Args:
        render_rirs_fn: (mic (N, 3), src (N, 3), rot (N, 3)) numpy arrays
            -> (N, C, F, T) log-magnitude STFTs, a tensor (e.g.
            JointPipeline.render_rirs).
        aabb: (2, 3) audio scene box; the grid spans its x/z extent.
    Returns:
        dict with mic_positions (N, 3) numpy, log_stfts (N, C, F, T) as
        render_rirs_fn returned them (on its device) and shape.
    """
    aabb = np.asarray(aabb)
    xs = np.linspace(aabb[0][0], aabb[1][0], resolution)
    zs = np.linspace(aabb[0][2], aabb[1][2], resolution)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    mics = np.stack([gx.reshape(-1), np.full(resolution**2, height),
                     gz.reshape(-1)], axis=-1).astype(np.float32)
    n = mics.shape[0]
    src = np.tile(np.asarray(source_pose, np.float32), (n, 1))
    rots = np.tile(np.asarray(rot, np.float32), (n, 1))
    return {"mic_positions": mics, "log_stfts": render_rirs_fn(mics, src, rots),
            "shape": (resolution, resolution)}


def loudness_map(log_stfts: torch.Tensor, shape: tuple[int, int]) -> np.ndarray:
    """(N, C, F, T) log-magnitude STFTs -> (res, res) RMS loudness in dB,
    reduced in float32 on their device."""
    mag = log_to_magnitude(log_stfts.float())
    rms = torch.sqrt(torch.mean(mag**2, dim=(1, 2, 3)))
    db = 20.0 * torch.log10(rms + 1e-9)
    return db.reshape(shape).cpu().numpy()


def loudness_image(lm: np.ndarray, size: int = 512) -> np.ndarray:
    """(res, res) loudness map -> (size, size, 3) uint8: viridis of the
    min-max normalised map, resized by nearest neighbour (the JAX CLI's
    matplotlib + PIL image, in numpy)."""
    norm = (lm - lm.min()) / max(lm.max() - lm.min(), 1e-9)
    return resize_nearest((_viridis(norm) * 255).astype(np.uint8), size, size)
