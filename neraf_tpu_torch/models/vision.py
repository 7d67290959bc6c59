"""Nerfacto-class vision model (counterpart of neraf_tpu/models/vision.py):

  1. uniform spacing bins (256) -> proposal net 0 -> weights -> PDF (96)
  2. -> proposal net 1 -> weights -> PDF resample (48)
  3. -> Nerfacto field -> density/rgb -> transmittance weights
  4. renderers: rgb (clipped to [0, 1]), accumulation, median and
     expected depth.

Eval runs deterministic sampling and no camera optimisation. Train mode
applies the SO3xR3 camera correction, jitters the bins at each of the three
samplers with one uniform per ray (use_single_jitter) or one per bin edge
(passed in by the caller),
resamples from the detached proposal weights raised to `anneal`, and uses
each camera's own appearance embedding. `loss` gives the rgb MSE and the
interlevel and distortion losses with their multipliers.
"""

from __future__ import annotations

import torch
from torch import nn

from neraf_tpu_torch.configs.config import VisionModelConfig
from neraf_tpu_torch.fields.nerfacto import (
    HashDensityField,
    NerfactoField,
    ProposalDensityField,
)
from neraf_tpu_torch.models.camera_opt import apply_camera_opt
from neraf_tpu_torch.ops.hashgrid import HashGridSpec
from neraf_tpu_torch.ops.render import (
    distortion_loss,
    interlevel_loss,
    render_accumulation,
    render_depth,
    render_rgb,
    render_weights,
)
from neraf_tpu_torch.ops.samplers import (
    bins_to_samples,
    pdf_spacing_bins,
    uniform_spacing_bins,
)
from neraf_tpu_torch.parallel.sharding import global_mean
from neraf_tpu_torch.utils.profiling import span


def _proposals(config: VisionModelConfig, dtype: torch.dtype) -> list:
    """The two proposal fields: fourier, or hash grids of the proposal_*
    sizes with one max_res each (the JAX package's ProposalFieldSpec
    defaults, which it cannot build: 'ProposalFieldSpec' has no
    'hash_grad_mode')."""
    density = config.average_init_density
    if config.proposal_encoding == "fourier":
        return [ProposalDensityField(average_init_density=density, dtype=dtype)
                for _ in range(2)]
    if config.proposal_encoding != "hash":
        raise ValueError(f"proposal_encoding={config.proposal_encoding!r}: "
                         "'fourier' or 'hash'")
    if len(config.proposal_max_res) != 2:
        raise ValueError(f"proposal_max_res={config.proposal_max_res!r}: one "
                         "max_res for each of the two proposal fields")
    return [HashDensityField(
        HashGridSpec(num_levels=config.proposal_num_levels,
                     features_per_level=config.proposal_features_per_level,
                     log2_hashmap_size=config.proposal_log2_hashmap_size,
                     base_res=config.proposal_base_res, max_res=max_res),
        config.proposal_hidden_dim, density, dtype)
        for max_res in config.proposal_max_res]


class VisionModel(nn.Module):
    """The two proposal fields and the main field, with the ray marcher."""

    def __init__(self, config: VisionModelConfig, num_cameras: int = 1,
                 near: float = 0.05, far: float = 1000.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.near, self.far = near, far
        self.field = NerfactoField(config, num_cameras, dtype)
        self.proposal_networks = nn.ModuleList(_proposals(config, dtype))
        # SO3xR3 corrections [omega, translation] per camera, zero-initialised
        self.camera_opt = nn.Parameter(torch.zeros(num_cameras, 6))

    def proposal(self, level: int) -> nn.Module:
        return self.proposal_networks[level]

    def reset_parameters(self, generator: torch.Generator | None = None):
        self.field.reset_parameters(generator)
        for prop in self.proposal_networks:
            prop.reset_parameters(generator)

    def forward(self, rays: dict, train: bool = False,
                use_average_appearance: bool | None = None,
                anneal: float = 1.0, jitter=None) -> dict:
        """Render a ray batch: origins (R, 3), directions (R, 3),
        camera_indices (R,) -> rgb (R, 3), accumulation, depth,
        expected_depth (R,), and the per-level weights and spacing bins.

        train: `jitter` is the three samplers' uniforms (u_init, u_pdf0,
        u_pdf1), each (R, 1), or (R, S + 1) for a sampler of S samples
        without use_single_jitter; use_average_appearance defaults to
        `not train`. Spans: vision.sampler (the camera correction, the
        uniform bins, each PDF resampling and the samples of each set of
        bins), vision.proposal (a proposal field and its weights; a hash
        proposal field's vision.proposal_encoding and vision.proposal_mlp
        under it),
        vision.field (the main field), vision.render (the renderers)."""
        cfg = self.config
        origins, directions = rays["origins"], rays["directions"]
        cam_idx = rays["camera_indices"]
        R = origins.shape[0]
        if use_average_appearance is None:
            use_average_appearance = not train
        if not train:
            jitter, anneal = (None, None, None), 1.0
        num_p0, num_p1 = cfg.num_proposal_samples
        with span("vision.sampler"):
            if train:
                origins, directions = apply_camera_opt(self.camera_opt, cam_idx,
                                                       origins, directions)
            near = torch.full((R,), self.near, device=origins.device)
            far = torch.full((R,), self.far, device=origins.device)
            bins = uniform_spacing_bins(R, num_p0, origins.device, jitter[0])
            s = bins_to_samples(bins, origins, directions, near, far)
        weights_list, spacing_list = [], []
        for level, n_next in ((0, num_p1), (1, cfg.num_nerf_samples)):
            with span("vision.proposal"):
                w = render_weights(self.proposal(level)(s["positions"]), s["deltas"])
            weights_list.append(w)
            spacing_list.append((s["spacing_starts"], s["spacing_ends"]))
            with span("vision.sampler"):
                # proposals learn only through the interlevel loss
                w_s = w.detach() ** anneal if train else w
                bins = pdf_spacing_bins(bins, w_s, n_next, jitter=jitter[level + 1])
                s = bins_to_samples(bins, origins, directions, near, far)

        with span("vision.field"):
            dirs_b = directions[:, None, :].expand(s["positions"].shape)
            cam_b = cam_idx[:, None].expand(s["positions"].shape[:-1])
            out = self.field(s["positions"], dirs_b, cam_b,
                             use_average_appearance=use_average_appearance)
        with span("vision.render"):
            w = render_weights(out["density"], s["deltas"])
            weights_list.append(w)
            spacing_list.append((s["spacing_starts"], s["spacing_ends"]))
            rgb = render_rgb(out["rgb"], w, background_color=cfg.background_color)
            return {
                "rgb": rgb.clamp(0.0, 1.0),  # reference NeRAF_model.py:67
                "accumulation": render_accumulation(w),
                "depth": render_depth(w, s["mids"]),
                "expected_depth": render_depth(w, s["mids"], method="expected"),
                "weights_list": weights_list,
                "spacing_list": spacing_list,
            }

    def loss(self, outputs: dict, gt_rgb: torch.Tensor, mesh=None) -> dict:
        """rgb MSE, interlevel (each proposal level against the final
        weights) and distortion losses, with their multipliers; means over
        the rays, of the global batch under a data mesh (each rank's means
        weighted by its rays, parallel/sharding.py::global_mean)."""
        cfg = self.config
        losses = {"rgb_loss": torch.mean((outputs["rgb"] - gt_rgb) ** 2)}
        w_final = outputs["weights_list"][-1]
        ss, se = outputs["spacing_list"][-1]
        inter = 0.0
        for w_prop, (ps, pe) in zip(outputs["weights_list"][:-1],
                                    outputs["spacing_list"][:-1]):
            inter = inter + interlevel_loss(w_final, ss, se, w_prop, ps, pe)
        losses["interlevel_loss"] = cfg.interlevel_loss_mult * inter
        losses["distortion_loss"] = cfg.distortion_loss_mult * distortion_loss(
            w_final, ss, se)
        if mesh is None:
            return losses
        values = global_mean(torch.stack(list(losses.values())), mesh,
                             gt_rgb.shape[0])
        return dict(zip(losses, values.unbind()))

    def query_density_rgb(self, positions: torch.Tensor,
                          directions: torch.Tensor):
        """Point queries for the scene-grid bake: no scene contraction, the
        average appearance embedding. (B, 3) each -> rgb (B, 3), density (B,)."""
        cam = torch.zeros(positions.shape[:-1], dtype=torch.long,
                          device=positions.device)
        out = self.field(positions, directions, cam, contract=False,
                         use_average_appearance=True)
        return out["rgb"], out["density"]
