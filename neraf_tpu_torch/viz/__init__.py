"""Visualization and offline tools: auralization, loudness maps, STFT
panels (the JAX package's neraf_tpu/viz exports)."""

from neraf_tpu_torch.viz.auralization import auralize, rir_from_log_stft
from neraf_tpu_torch.viz.loudness import loudness_map, render_loudness_grid
from neraf_tpu_torch.viz.panels import grid_top_view, stft_comparison_panel

__all__ = [
    "auralize",
    "rir_from_log_stft",
    "loudness_map",
    "render_loudness_grid",
    "stft_comparison_panel",
    "grid_top_view",
]
