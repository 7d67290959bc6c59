"""Traffic of kind "nerfacto_image": the image kind's closed-loop viewer
(portbench/kinds/image.py) on NeRAF's published radiance model,
nerfstudio's Nerfacto. Its configuration's vision section holds what the
image kind's configurations do not: `proposal`, a list of two hash grids
that differ only in max_res, `hash.hidden_layers` and
`hidden_layers_color`. The port's ExperimentConfig is
program.experiment_config's plus these fields (a program without them
fails here, in set-up), its weights and reference come from
portbench/reference/nerfacto.py, and the work an image holds is counted
below from the configuration's shapes."""

from __future__ import annotations

import dataclasses

import torch

from portbench.core import inputs, program, serve
from portbench.core.common import Run
from portbench.core.yardstick import hash_fwd_bound_ms, mlp_flops
from portbench.kinds.image import ImageServer
from portbench.reference import nerfacto as ref
from portbench.reference.neraf import SH_DIM, hash_out_dim


def experiment_config(spec: dict):
    """program.experiment_config(spec) with the hash proposal fields and
    the fields' depths."""
    cfg, v = program.experiment_config(spec), spec["vision"]
    p0, p1 = ref.grids(v)
    if p0["encoding"] != "hash" or any(p1[k] != p0[k] for k in p0 if k != "max_res"):
        raise ValueError("the port's proposal fields are two hash grids that differ "
                         f"only in max_res, not {v['proposal']}")
    cfg.vision_model = dataclasses.replace(
        cfg.vision_model, proposal_encoding="hash",
        hidden_layers=v["hash"]["hidden_layers"],
        hidden_layers_color=v["hidden_layers_color"],
        proposal_num_levels=p0["num_levels"],
        proposal_features_per_level=p0["features_per_level"],
        proposal_log2_hashmap_size=p0["log2_hashmap_size"],
        proposal_base_res=p0["base_res"],
        proposal_max_res=(p0["max_res"], p1["max_res"]),
        proposal_hidden_dim=p0["hidden_dim"])
    return cfg


def vision_pipeline(spec: dict, cfg, device):
    """VisionPipeline of the file's radiance model (program.vision_pipeline
    on `cfg`)."""
    from neraf_tpu_torch.engine.pipeline import VisionPipeline
    from neraf_tpu_torch.models.vision import VisionModel

    v = spec["vision"]
    dtype = torch.bfloat16 if spec["mixed_precision"] else torch.float32
    with torch.device(device):
        model = VisionModel(cfg.vision_model, num_cameras=v["num_cameras"], near=v["near"],
                            far=v["far"], dtype=dtype)
    return VisionPipeline(cfg, model, device)


def _proposal_points(v: dict, rays: int):
    """(grid, points) of each proposal field over an image's rays."""
    return zip(ref.grids(v), (rays * n for n in v["num_proposal_samples"]))


def flops(v: dict, rays: int) -> float:
    """Model FLOPs of an image: each proposal MLP on its samples, the base
    MLP and the colour head on the main field's (the encodings' arithmetic
    left out, as yardstick.py leaves it out for the other cells)."""
    h, hc, geo = v["hash"], v["hidden_dim_color"], v["geo_feat_dim"]
    pts = rays * v["num_nerf_samples"]
    prop = sum(mlp_flops([p["num_levels"] * p["features_per_level"], p["hidden_dim"], 1], n)
               for p, n in _proposal_points(v, rays))
    base = [hash_out_dim(v)] + [h["hidden_dim"]] * h["hidden_layers"] + [1 + geo]
    head = ([SH_DIM + geo + v["appearance_embed_dim"]] + [hc] * v["hidden_layers_color"]
            + [3])
    return prop + mlp_flops(base, pts) + mlp_flops(head, pts)


def pixels(height: int, width: int) -> int:
    """An image's pixels, one ray each."""
    return height * width


def proposal_points(v: dict, rays: int) -> int:
    """Samples of both proposal fields over an image's rays (what the
    program's counter image.proposal_points counts an image)."""
    return sum(n for _, n in _proposal_points(v, rays))


def proposal_hash_bound_ms(v: dict, rays: int) -> float:
    """Least time of both proposal fields' hash encodings of an image
    (yardstick.hash_fwd_bound_ms: the table rows left out)."""
    return sum(hash_fwd_bound_ms({"hash": p}, n) for p, n in _proposal_points(v, rays))


def hash_bound_ms(v: dict, rays: int) -> float:
    """Least time of every hash encoding of an image, both proposals' and
    the main field's: hash_roofline.image reads every hash_encoding_fwd
    launch."""
    return (proposal_hash_bound_ms(v, rays)
            + hash_fwd_bound_ms(v, rays * v["num_nerf_samples"]))


class NerfactoServer(ImageServer):
    """ImageServer on Nerfacto: the same requests and gaps; the program,
    the weights, the reference and the work are this configuration's."""

    def __init__(self, run: Run):
        spec, dev, tr = run.spec, run.device, run.traffic
        self.run, self.spec = run, spec
        self.H, self.W = tr["height"], tr["width"]
        cfg = experiment_config(spec)
        self.weights = inputs.make_weights(ref.param_shapes(spec), run.seed, dev)
        self.cams = inputs.cameras(tr["camera_pool"], inputs.generator(dev, run.seed, "cameras"),
                                   tr["position_box"], tr["pitch_deg"], tr["focal"],
                                   self.H, self.W)
        if run.control:
            self.pipe = None
            return
        pipe = vision_pipeline(spec, cfg, dev)
        inputs.load_weights(pipe.vision_model, self.weights, ref.PREFIX)
        self.pipe = pipe

    def reference(self, cam, precision):
        return ref.render_image(self.weights, self.spec["vision"], cam, self.H, self.W,
                                precision)

    def work(self) -> dict:
        v, rays = self.spec["vision"], self.H * self.W
        return {"flops": flops(v, rays), "pixels": pixels(self.H, self.W),
                "hash_bound_ms": hash_bound_ms(v, rays),
                "proposal_hash_bound_ms": proposal_hash_bound_ms(v, rays),
                "proposal_points": proposal_points(v, rays)}


def drive(run: Run):
    return serve.drive(run, NerfactoServer(run))
