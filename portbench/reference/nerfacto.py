"""Plain PyTorch reference of NeRAF's published radiance model, nerfstudio's
Nerfacto (NeRAF_model.py:54, NeRAF_config.py:94-98 on nerfstudio's
models/nerfacto.py NerfactoModelConfig), written from the configuration's
numbers alone:

- two proposal fields, each nerfstudio's HashMLPDensityField
  (fields/density_fields.py): positions contracted (inf-norm) into the
  radius-2 ball and mapped to [0, 1]^3 as (x + 2) / 4, the position zeroed
  where it lies outside (0, 1)^3, a hash grid, one ReLU layer, a 1-wide
  output; density = average_init_density * trunc_exp(output) * mask;
- the main field, NerfactoField: the hash grid, a base MLP of
  `hash.hidden_layers` ReLU layers to 1 + geo_feat_dim, trunc_exp density;
  the colour head of `hidden_layers_color` ReLU layers over [SH4 of the
  direction, geo features, appearance embedding] and a sigmoid;
- the piecewise lin/disp samplers (256, 96) -> 48, volume rendering and
  Nerfacto's losses, as portbench/reference/neraf.py computes them.

Its departures from nerfstudio, each the port's too:
- products run in float32 here and in bfloat16 in the port, where tcnn
  computes in float16;
- the hash grids index as nerfstudio's torch implementation does
  (resolutions floor(base * growth^l), corners on integer multiples), not
  as tcnn, which offsets a level by half a cell;
- the samplers' jitter is the port's: one uniform a ray and sampler in
  training (use_single_jitter), given by the caller, none at eval;
- none in the appearance: at eval every sample takes the mean of the
  embeddings, as Nerfacto's use_average_appearance_embedding (True) does,
  and the port's every eval path.

Weights are a flat dict {name: float32 tensor} under the port's parameter
names (`param_shapes`); `precision` "fp8" rounds every product's inputs and
outputs to float8 e4m3 (neraf.py::rounded), the control's step below the
configuration's bfloat16. Nothing here imports the measured program or
JAX.
"""

from __future__ import annotations

import torch

from portbench.reference import neraf as ref

PREFIX = "vision_model."


def grids(v: dict) -> list:
    """The vision section's proposal grids: a list of two dicts."""
    props = v["proposal"]
    if not isinstance(props, list) or len(props) != 2:
        raise ValueError("the proposal section is a list of two hash grids")
    return props


def param_shapes(spec: dict) -> dict:
    """{name: shape} of the vision model's weights for the configuration's
    "model" section, named as the port's VisionModel nests them."""
    v, s, prefix = spec["vision"], {}, PREFIX
    if v["encoding"] != "hash":
        raise ValueError("Nerfacto's main field is a hash grid")
    f, h = f"{prefix}field", v["hash"]
    s[f"{f}.hash.table"] = (h["num_levels"], 1 << h["log2_hashmap_size"],
                            h["features_per_level"])
    width, enc = h["hidden_dim"], ref.hash_out_dim(v)
    for i, d in enumerate([enc] + [width] * (h["hidden_layers"] - 1)):
        ref._lin(s, f"{f}.mlp_base.{i}", d, width)
    ref._lin(s, f"{f}.base_out", width, 1 + v["geo_feat_dim"])
    hc = v["hidden_dim_color"]
    head_in = ref.SH_DIM + v["geo_feat_dim"] + v["appearance_embed_dim"]
    for i, d in enumerate([head_in] + [hc] * (v["hidden_layers_color"] - 1)):
        ref._lin(s, f"{f}.mlp_head.{i}", d, hc)
    ref._lin(s, f"{f}.head_out", hc, 3)
    s[f"{f}.appearance.weight"] = (v["num_cameras"], v["appearance_embed_dim"])
    for k, p in enumerate(grids(v)):
        q = f"{prefix}proposal_networks.{k}"
        s[f"{q}.hash.table"] = (p["num_levels"], 1 << p["log2_hashmap_size"],
                                p["features_per_level"])
        ref._lin(s, f"{q}.mlp.0", p["num_levels"] * p["features_per_level"],
                 p["hidden_dim"])
        ref._lin(s, f"{q}.mlp.1", p["hidden_dim"], 1)
    s[f"{prefix}camera_opt"] = (v["num_cameras"], 6)
    return s


def proposal_density(P, prefix, p: dict, density_scale: float, positions,
                     precision=None, contract=True):
    """HashMLPDensityField: (..., 3) positions -> densities (...,)."""
    x = ref.contract_to_unit(positions) if contract else positions
    inside = torch.all((x > 0.0) & (x < 1.0), dim=-1)
    x = x * inside[..., None]
    h = ref.mlp(ref.hash_encoding(P[f"{prefix}hash.table"], x, p), P,
                [f"{prefix}mlp.0", f"{prefix}mlp.1"], precision)
    return density_scale * ref._TruncExp.apply(h[..., 0]) * inside


def main_field(P, prefix, v, positions, directions, cam, contract,
               average_appearance, precision):
    """NerfactoField -> density (...,), rgb (..., 3)."""
    f, h = f"{prefix}field", v["hash"]
    if contract:
        x, inside = ref.contract_to_unit(positions), None
    else:
        x = (positions + 1.0) / 2.0
        inside = torch.all((x > 0.0) & (x < 1.0), dim=-1)
    enc = ref.hash_encoding(P[f"{f}.hash.table"], x, h)
    names = [f"{f}.mlp_base.{i}" for i in range(h["hidden_layers"])] + [f"{f}.base_out"]
    out = ref.mlp(enc, P, names, precision)
    density = v["average_init_density"] * ref._TruncExp.apply(out[..., 0])
    if inside is not None:
        density = density * inside
    emb_w = P[f"{f}.appearance.weight"]
    if average_appearance:
        emb = emb_w.mean(dim=0).expand(*out.shape[:-1], emb_w.shape[1])
    else:
        emb = emb_w[cam]
    hh = torch.cat([ref.sh_encoding((directions + 1.0) / 2.0), out[..., 1:], emb], -1)
    names = ([f"{f}.mlp_head.{i}" for i in range(v["hidden_layers_color"])]
             + [f"{f}.head_out"])
    return density, torch.sigmoid(ref.mlp(hh, P, names, precision))


def vision_forward(P, v, origins, directions, cam, train, precision=None,
                   anneal=1.0, jitter=(None, None, None)):
    """Proposal 0 -> proposal 1 -> the main field -> rgb, accumulation,
    median depth, and each level's weights and spacing bins
    (neraf.py::vision_forward on Nerfacto's fields)."""
    R, prefix = origins.shape[0], PREFIX
    if train:
        corr = P[f"{prefix}camera_opt"][cam]
        origins = origins + corr[..., 3:]
        directions = torch.einsum("bij,bj->bi", ref.exp_so3(corr[..., :3]), directions)
    near = torch.full((R,), v["near"], device=origins.device)
    far = torch.full((R,), v["far"], device=origins.device)
    n0, n1 = v["num_proposal_samples"]
    bins = ref.uniform_bins(R, n0, origins.device, jitter[0])
    ws, sp = [], []
    for level, (p, n_next) in enumerate(zip(grids(v), (n1, v["num_nerf_samples"]))):
        s = ref.samples(bins, origins, directions, near, far)
        density = proposal_density(P, f"{prefix}proposal_networks.{level}.", p,
                                   v["average_init_density"], s["positions"], precision)
        w = ref.render_weights(density, s["deltas"])
        ws.append(w)
        sp.append((s["ss"], s["se"]))
        bins = ref.pdf_bins(bins, w.detach() ** anneal if train else w, n_next,
                            jitter[level + 1])
    s = ref.samples(bins, origins, directions, near, far)
    dirs = directions[:, None, :].expand(s["positions"].shape)
    density, rgb = main_field(P, prefix, v, s["positions"], dirs,
                              cam[:, None].expand(s["positions"].shape[:-1]),
                              True, not train, precision)
    w = ref.render_weights(density, s["deltas"])
    ws.append(w)
    sp.append((s["ss"], s["se"]))
    acc = w.sum(-1)
    color = torch.sum(w[..., None] * rgb, -2) + rgb[..., -1, :] * (1.0 - acc[..., None])
    return {"rgb": color.clamp(0.0, 1.0), "accumulation": acc,
            "depth": ref.median_depth(w, s["mids"]), "weights": ws, "spacing": sp}


vision_losses = ref.vision_losses  # rgb MSE, interlevel and distortion


def render_image(P, v, cam1, height, width, precision=None):
    """One eval image of camera `cam1` (a dict of one camera) in chunks of
    eval_num_rays_per_chunk rays -> rgb (H, W, 3), depth, accumulation."""
    dev = cam1["c2w"].device
    ys, xs = torch.meshgrid(torch.arange(height, device=dev),
                            torch.arange(width, device=dev), indexing="ij")
    ys, xs = ys.reshape(-1), xs.reshape(-1)
    chunk, parts = v["eval_num_rays_per_chunk"], []
    with torch.no_grad():
        for i in range(0, ys.shape[0], chunk):
            px, py = xs[i:i + chunk], ys[i:i + chunk]
            cam = torch.zeros_like(px)
            o, d = ref.camera_rays(cam1, cam, px, py)
            out = vision_forward(P, v, o, d, cam, False, precision)
            parts.append((out["rgb"], out["depth"], out["accumulation"]))
    rgb, depth, acc = (torch.cat(p) for p in zip(*parts))
    return {"rgb": rgb.reshape(height, width, 3), "depth": depth.reshape(height, width),
            "accumulation": acc.reshape(height, width)}
