"""Plain PyTorch reference of what the benchmark's cells time.

NeRAF (ICLR 2025) as nerfstudio's Nerfacto and the NeRAF acoustic field
compute it, written from the configuration's numbers alone: the vision
model (fourier or hash main field, two fourier proposal fields, SO3xR3
camera corrections, the lin/disp spacing samplers, volume rendering and
Nerfacto's losses), the scene-grid bake, the 3D ResNet over the grid
(train-mode BatchNorm with flax's running-statistics update, or eval), the
acoustic field with its STFT losses, Griffin-Lim, and the joint step's
four Adam groups.

Every function takes its weights as a flat dict {name: float32 tensor};
the names follow the order and nesting of the model (`param_shapes`).
Products run in float32 with TF32 off, or, for the control, with their
inputs and outputs held in float8 e4m3 with one scale a tensor
(`precision` "fp8"), as the program holds them in the bfloat16 that the
configuration states: the step below it.

Nothing here imports the measured program or JAX.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3 value
BN_EPS, BN_MOMENTUM = 1e-5, 0.1
ADAM_BETAS = (0.9, 0.999)
SH_DIM = 16
GRID_CHANNELS = 7


def exact_float32() -> None:
    """Full float32 products: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rounded(x: torch.Tensor, precision: str | None) -> torch.Tensor:
    """x as a product reads it: unchanged, or rounded to float8 e4m3 on a
    per-tensor scale (amax to 448), the gradient passed straight through."""
    if precision is None:
        return x
    if precision != "fp8":
        raise ValueError(f"precision {precision!r}: None or 'fp8'")
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


def linear(x, w, b, precision=None):
    return rounded(rounded(x, precision) @ rounded(w, precision).T + b, precision)


def conv3d(x, w, stride, padding, precision=None):
    return rounded(F.conv3d(rounded(x, precision), rounded(w, precision), None,
                            stride, padding), precision)


# ----------------------------------------------------------------- shapes

def resnet_blocks(backbone: str):
    """(bottleneck?, blocks a stage) of a 3D ResNet backbone."""
    table = {"resnet18": (False, (2, 2, 2, 2)), "resnet50": (True, (3, 4, 6, 3))}
    return table[backbone]


def resnet_stages(spec: dict):
    """[(name, in_ch, planes, stride, bottleneck, downsample)] of every block."""
    bottleneck, layers = resnet_blocks(spec["resnet"])
    exp = 4 if bottleneck else 1
    stages = [(64, 1), (128, 2), (256, 2)]
    if spec["n_features"] == 2048:
        stages.append((512, 2))
    out, in_ch = [], 64
    for i, ((planes, stride), blocks) in enumerate(zip(stages, layers)):
        for b in range(blocks):
            s = stride if b == 0 else 1
            down = b == 0 and (s != 1 or in_ch != planes * exp)
            out.append((f"layer{i + 1}.{b}", in_ch, planes, s, bottleneck, down))
            in_ch = planes * exp
    return out


def resnet_feature_dim(spec: dict) -> int:
    bottleneck, _ = resnet_blocks(spec["resnet"])
    return (512 if spec["n_features"] == 2048 else 256) * (4 if bottleneck else 1)


def _bn_shapes(name, ch):
    return {f"{name}.{k}": (ch,) for k in
            ("weight", "bias", "running_mean", "running_var")}


def resnet_shapes(spec: dict, prefix: str = "") -> dict:
    s = {f"{prefix}conv1.weight": (64, GRID_CHANNELS, 5, 5, 5),
         **_bn_shapes(f"{prefix}bn1", 64)}
    for name, cin, planes, _, bottleneck, down in resnet_stages(spec):
        p = f"{prefix}{name}"
        if bottleneck:
            s[f"{p}.conv1.weight"] = (planes, cin, 1, 1, 1)
            s.update(_bn_shapes(f"{p}.bn1", planes))
            s[f"{p}.conv2.weight"] = (planes, planes, 3, 3, 3)
            s.update(_bn_shapes(f"{p}.bn2", planes))
            s[f"{p}.conv3.weight"] = (4 * planes, planes, 1, 1, 1)
            s.update(_bn_shapes(f"{p}.bn3", 4 * planes))
            out = 4 * planes
        else:
            s[f"{p}.conv1.weight"] = (planes, cin, 3, 3, 3)
            s.update(_bn_shapes(f"{p}.bn1", planes))
            s[f"{p}.conv2.weight"] = (planes, planes, 3, 3, 3)
            s.update(_bn_shapes(f"{p}.bn2", planes))
            out = planes
        if down:
            s[f"{p}.down_conv.weight"] = (out, cin, 1, 1, 1)
            s.update(_bn_shapes(f"{p}.down_bn", out))
    return s


def _lin(s, name, i, o):
    s[f"{name}.weight"] = (o, i)
    s[f"{name}.bias"] = (o,)


def audio_in_dim(spec: dict) -> int:
    return resnet_feature_dim(spec) + 21 + 2 * 63 + SH_DIM


def field_shapes(spec: dict, prefix: str = "") -> dict:
    s = {}
    widths = (audio_in_dim(spec), *spec["trunk"], spec["w_field"])
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        _lin(s, f"{prefix}trunk.{i}", a, b)
    for c in range(spec["mic_ch"]):
        _lin(s, f"{prefix}heads.{c}", spec["w_field"], spec["n_freq_stft"])
    return s


def hash_out_dim(v: dict) -> int:
    return v["hash"]["num_levels"] * v["hash"]["features_per_level"]


def vision_shapes(v: dict, prefix: str = "") -> dict:
    s = {}
    f = f"{prefix}field"
    if v["encoding"] == "hash":
        h = v["hash"]
        s[f"{f}.hash.table"] = (h["num_levels"], 1 << h["log2_hashmap_size"],
                                h["features_per_level"])
        width, layers, enc = h["hidden_dim"], 2, hash_out_dim(v)
    else:
        width, layers = v["base_mlp_width"], v["base_mlp_layers"]
        enc = 6 * v["num_frequencies"] + 3
    dims = [enc] + [width] * (layers - 1)
    for i, d in enumerate(dims):
        _lin(s, f"{f}.mlp_base.{i}", d, width)
    _lin(s, f"{f}.base_out", width, 1 + v["geo_feat_dim"])
    hc = v["hidden_dim_color"]
    head_in = SH_DIM + v["geo_feat_dim"] + v["appearance_embed_dim"]
    for i, d in enumerate((head_in, hc, hc)):
        _lin(s, f"{f}.mlp_head.{i}", d, hc)
    _lin(s, f"{f}.head_out", hc, 3)
    s[f"{f}.appearance.weight"] = (v["num_cameras"], v["appearance_embed_dim"])
    p = v["proposal"]
    pd = [6 * p["num_frequencies"] + 3] + [p["width"]] * p["layers"] + [1]
    for k in range(2):
        for i, (a, b) in enumerate(zip(pd[:-1], pd[1:])):
            _lin(s, f"{prefix}proposal_networks.{k}.mlp.{i}", a, b)
    s[f"{prefix}camera_opt"] = (v["num_cameras"], 6)
    return s


def param_shapes(spec: dict, parts) -> dict:
    """{name: shape} of the weights and BatchNorm statistics of the parts
    ("vision", "resnet", "field"), named as the joint model nests them."""
    s = {}
    if "vision" in parts:
        s.update(vision_shapes(spec["vision"], "vision_model."))
    if "resnet" in parts:
        s.update(resnet_shapes(spec["audio"], "resnet."))
    if "field" in parts:
        s.update(field_shapes(spec["audio"], "audio_model.field."))
    return s


# ------------------------------------------------------------- encodings

def nerf_encoding(x, num_frequencies, min_exp=0.0, max_exp=8.0):
    """(..., D) -> [sin over D F (d-major), cos over D F, x]."""
    freqs = 2.0 ** torch.linspace(min_exp, max_exp, num_frequencies,
                                  dtype=torch.float32, device=x.device)
    ang = ((2.0 * math.pi * x)[..., None] * freqs).reshape(*x.shape[:-1], -1)
    return torch.cat([torch.sin(ang), torch.cos(ang), x], dim=-1)


def sh_encoding(d):
    """Degree-4 real spherical harmonics of (..., 3) values in [0, 1]."""
    v = d * 2.0 - 1.0
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    x2, y2, z2 = x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814), -0.48860251190291987 * y,
        0.48860251190291987 * z, -0.48860251190291987 * x,
        1.0925484305920792 * x * y, -1.0925484305920792 * y * z,
        0.94617469575755997 * z2 - 0.31539156525251999,
        -1.0925484305920792 * x * z, 0.54627421529603959 * (x2 - y2),
        0.59004358992664352 * y * (-3.0 * x2 + y2), 2.8906114426405538 * x * y * z,
        0.45704579946446572 * y * (1.0 - 5.0 * z2),
        0.3731763325901154 * z * (5.0 * z2 - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * z2),
        1.4453057213202769 * z * (x2 - y2),
        0.59004358992664352 * x * (-x2 + 3.0 * y2)], dim=-1)


HASH_PRIMES = (1, 2654435761, 805459861)


def hash_encoding(table, x, h: dict):
    """instant-NGP multiresolution hash encoding: (..., 3) in [0, 1] ->
    (..., L F), trilinear over each level's 8 corners, dense indexing on
    the levels whose (res + 1)^3 corners fit the table, the XOR-prime hash
    mod T on the others."""
    L, Fd, T = h["num_levels"], h["features_per_level"], 1 << h["log2_hashmap_size"]
    growth = math.exp((math.log(h["max_res"]) - math.log(h["base_res"])) / (L - 1))
    res_np = np.floor(h["base_res"] * growth ** np.arange(L)).astype(np.int64)
    lead = x.shape[:-1]
    xf = torch.minimum(torch.maximum(x.reshape(-1, 3), x.new_zeros(())),
                       x.new_ones(()))
    out = []
    for lvl in range(L):
        r = int(res_np[lvl])
        pos = xf * r
        c0 = torch.floor(pos)
        frac = pos - c0
        c0 = c0.long()
        acc = 0.0
        for i in (0, 1):
            for j in (0, 1):
                for k in (0, 1):
                    c = torch.minimum(c0 + torch.tensor((i, j, k), device=x.device),
                                      torch.tensor(r, device=x.device))
                    if (r + 1) ** 3 <= T:
                        idx = c[:, 0] + c[:, 1] * (r + 1) + c[:, 2] * (r + 1) ** 2
                    else:
                        m = 0xFFFFFFFF
                        idx = ((c[:, 0] * HASH_PRIMES[0]) & m) ^ (
                            (c[:, 1] * HASH_PRIMES[1]) & m)
                        idx = (idx ^ ((c[:, 2] * HASH_PRIMES[2]) & m)) & (T - 1)
                    wx = frac[:, 0] if i else 1.0 - frac[:, 0]
                    wy = frac[:, 1] if j else 1.0 - frac[:, 1]
                    wz = frac[:, 2] if k else 1.0 - frac[:, 2]
                    acc = acc + table[lvl].index_select(0, idx) * (wx * wy * wz)[:, None]
        out.append(acc)
    return torch.cat(out, dim=-1).reshape(*lead, L * Fd)


class _TruncExp(torch.autograd.Function):
    """exp with its input clamped to [-15, 15] in the gradient."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(-15.0, 15.0))


def contract_to_unit(x):
    """Scene contraction (inf-norm) into the radius-2 ball, then [0, 1]^3."""
    mag = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-10)
    c = torch.where(mag <= 1.0, x, (2.0 - 1.0 / mag) * (x / mag))
    return (c + 2.0) / 4.0


def mlp(h, P, names, precision, act=torch.relu):
    for i, n in enumerate(names):
        h = linear(h, P[f"{n}.weight"], P[f"{n}.bias"], precision)
        if i < len(names) - 1:
            h = act(h)
    return h


# ----------------------------------------------------------------- fields

def proposal_density(P, prefix, v, positions, precision):
    p = v["proposal"]
    x = contract_to_unit(positions)
    names = [f"{prefix}mlp.{i}" for i in range(p["layers"] + 1)]
    h = mlp(nerf_encoding(x, p["num_frequencies"]), P, names, precision)
    return v["average_init_density"] * _TruncExp.apply(h[..., 0])


def main_field(P, prefix, v, positions, directions, cam, contract,
               average_appearance, precision):
    """The Nerfacto field -> density (...,), rgb (..., 3)."""
    f = f"{prefix}field"
    if contract:
        x, inside = contract_to_unit(positions), None
    else:
        x = (positions + 1.0) / 2.0
        inside = torch.all((x > 0.0) & (x < 1.0), dim=-1)
    if v["encoding"] == "hash":
        enc = hash_encoding(P[f"{f}.hash.table"], x, v["hash"])
        n_base = 2
    else:
        enc = nerf_encoding(x, v["num_frequencies"])
        n_base = v["base_mlp_layers"]
    names = [f"{f}.mlp_base.{i}" for i in range(n_base)] + [f"{f}.base_out"]
    h = mlp(enc, P, names, precision)
    density = v["average_init_density"] * _TruncExp.apply(h[..., 0])
    if inside is not None:
        density = density * inside
    emb_w = P[f"{f}.appearance.weight"]
    if average_appearance:
        emb = emb_w.mean(dim=0).expand(*h.shape[:-1], emb_w.shape[1])
    else:
        emb = emb_w[cam]
    hh = torch.cat([sh_encoding((directions + 1.0) / 2.0), h[..., 1:], emb], -1)
    names = [f"{f}.mlp_head.{i}" for i in range(3)] + [f"{f}.head_out"]
    rgb = torch.sigmoid(mlp(hh, P, names, precision))
    return density, rgb


# ------------------------------------------------------ samplers, render

def _s2e(s):
    return torch.where(s < 0.5, 2.0 * s, 1.0 / (2.0 * (1.0 - s.clamp_max(1.0 - 1e-7))))


def _e2s(t):
    return torch.where(t < 1.0, t / 2.0, 1.0 - 1.0 / (2.0 * t.clamp_min(1e-7)))


def uniform_bins(n_rays, n, device, jitter=None):
    edges = torch.linspace(0.0, 1.0, n + 1, device=device).expand(n_rays, n + 1)
    if jitter is None:
        return edges
    width = 1.0 / n
    if jitter.shape[-1] > 1:
        jitter = jitter[..., :n - 1]
    inner = (edges[..., 1:-1] + jitter * width - width / 2.0).clamp(0.0, 1.0)
    return torch.cat([edges[..., :1], inner, edges[..., -1:]], -1)


def pdf_bins(bins, weights, n, jitter=None, padding=0.01):
    """Inverse-CDF resampling of spacing bins at (i + u) / (n + 1)."""
    nb = n + 1
    w = weights + padding / weights.shape[-1]
    w_sum = w.sum(-1, keepdim=True)
    pad = (1e-5 - w_sum).clamp_min(0.0)
    w = w + pad / w.shape[-1]
    w_sum = w_sum + pad
    cdf = torch.cumsum((w / w_sum)[..., :-1], -1).clamp_max(1.0)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf,
                     torch.ones_like(cdf[..., :1])], -1)
    u = torch.linspace(0.0, 1.0 - 1.0 / nb, nb, device=cdf.device)
    u = u + (0.5 / nb if jitter is None else jitter / nb)
    u = u.expand(*cdf.shape[:-1], nb).contiguous()
    above = torch.searchsorted(cdf, u, right=True).clamp(1, cdf.shape[-1] - 1)
    below = above - 1
    c0, c1 = cdf.gather(-1, below), cdf.gather(-1, above)
    b0, b1 = bins.gather(-1, below), bins.gather(-1, above)
    d = c1 - c0
    t = torch.where(d > 1e-12, (u - c0) / d, torch.zeros_like(u)).clamp(0.0, 1.0)
    return b0 + t * (b1 - b0)


def samples(bins, origins, directions, near, far):
    s_near, s_far = _e2s(near), _e2s(far)
    t = _s2e(bins * s_far[..., None] + (1.0 - bins) * s_near[..., None])
    starts, ends = t[..., :-1], t[..., 1:]
    mids = (starts + ends) / 2.0
    return {"positions": origins[..., None, :] + directions[..., None, :] * mids[..., None],
            "deltas": ends - starts, "mids": mids,
            "ss": bins[..., :-1], "se": bins[..., 1:]}


def render_weights(density, deltas):
    dd = density * deltas
    acc = torch.cumsum(dd, -1)
    acc = torch.cat([torch.zeros_like(acc[..., :1]), acc[..., :-1]], -1)
    return (1.0 - torch.exp(-dd)) * torch.exp(-acc)


def median_depth(w, mids):
    cum = torch.cumsum(w, -1)
    idx = torch.searchsorted(cum, torch.full_like(cum[..., :1], 0.5))
    return mids.gather(-1, idx.clamp(0, mids.shape[-1] - 1))[..., 0]


def _outer(t0s, t0e, t1s, t1e, y1):
    cy1 = torch.cat([torch.zeros_like(y1[..., :1]), torch.cumsum(y1, -1)], -1)
    lo = torch.searchsorted(t1s.contiguous(), t0s.contiguous(), right=True)
    hi = torch.searchsorted(t1e.contiguous(), t0e.contiguous())
    return (cy1.gather(-1, (hi + 1).clamp_max(y1.shape[-1]))
            - cy1.gather(-1, (lo - 1).clamp_min(0)))


def interlevel(w, ss, se, wp, ps, pe):
    w = w.detach()
    c = (w - _outer(ss.detach(), se.detach(), ps, pe, wp)).clamp_min(0.0)
    return torch.mean(c ** 2 / (w + 1e-7))


def distortion(w, ss, se):
    mid, dt = (ss + se) / 2.0, se - ss
    inner = torch.sum(w[..., :, None] * w[..., None, :]
                      * torch.abs(mid[..., :, None] - mid[..., None, :]), (-1, -2))
    return torch.mean(inner + torch.sum(w ** 2 * dt, -1) / 3.0)


def exp_so3(omega):
    sq = torch.sum(omega * omega, -1, keepdim=True)[..., None]
    theta = torch.sqrt(sq.clamp_min(1e-16))
    z = torch.zeros_like(omega[..., 0])
    wx, wy, wz = omega.unbind(-1)
    K = torch.stack([torch.stack([z, -wz, wy], -1), torch.stack([wz, z, -wx], -1),
                     torch.stack([-wy, wx, z], -1)], -2)
    eye = torch.eye(3, device=omega.device).expand(K.shape)
    ts = theta.clamp_min(1e-8)
    R = eye + torch.sin(ts) / ts * K + (1.0 - torch.cos(ts)) / ts ** 2 * (K @ K)
    return torch.where(theta < 1e-7, eye + K, R)


def camera_rays(cams, cam, px, py):
    """Pixel centres of OpenGL pinhole cameras (-z forward) -> world rays."""
    x = (px.float() + 0.5 - cams["cx"][cam]) / cams["fx"][cam]
    y = (py.float() + 0.5 - cams["cy"][cam]) / cams["fy"][cam]
    d = torch.stack([x, -y, -torch.ones_like(x)], -1)
    c2w = cams["c2w"][cam]
    d = torch.einsum("bij,bj->bi", c2w[:, :3, :3], d)
    return c2w[:, :3, 3], d / torch.linalg.norm(d, dim=-1, keepdim=True)


def vision_forward(P, v, origins, directions, cam, train, precision=None,
                   anneal=1.0, jitter=(None, None, None), prefix="vision_model."):
    """Proposal 0 -> proposal 1 -> Nerfacto field -> rgb, accumulation,
    median depth, and each level's weights and spacing bins."""
    R = origins.shape[0]
    if train:
        corr = P[f"{prefix}camera_opt"][cam]
        origins = origins + corr[..., 3:]
        directions = torch.einsum("bij,bj->bi", exp_so3(corr[..., :3]), directions)
    near = torch.full((R,), v["near"], device=origins.device)
    far = torch.full((R,), v["far"], device=origins.device)
    n0, n1 = v["num_proposal_samples"]
    bins = uniform_bins(R, n0, origins.device, jitter[0])
    ws, sp = [], []
    for level, n_next in ((0, n1), (1, v["num_nerf_samples"])):
        s = samples(bins, origins, directions, near, far)
        w = render_weights(proposal_density(
            P, f"{prefix}proposal_networks.{level}.", v, s["positions"], precision),
            s["deltas"])
        ws.append(w)
        sp.append((s["ss"], s["se"]))
        bins = pdf_bins(bins, w.detach() ** anneal if train else w, n_next,
                        jitter[level + 1])
    s = samples(bins, origins, directions, near, far)
    dirs = directions[:, None, :].expand(s["positions"].shape)
    density, rgb = main_field(P, prefix, v, s["positions"], dirs,
                              cam[:, None].expand(s["positions"].shape[:-1]),
                              True, not train, precision)
    w = render_weights(density, s["deltas"])
    ws.append(w)
    sp.append((s["ss"], s["se"]))
    acc = w.sum(-1)
    color = torch.sum(w[..., None] * rgb, -2) + rgb[..., -1, :] * (1.0 - acc[..., None])
    return {"rgb": color.clamp(0.0, 1.0), "accumulation": acc,
            "depth": median_depth(w, s["mids"]), "weights": ws, "spacing": sp}


def vision_losses(v, out, gt_rgb):
    ss, se = out["spacing"][-1]
    w = out["weights"][-1]
    inter = sum(interlevel(w, ss, se, wp, ps, pe)
                for wp, (ps, pe) in zip(out["weights"][:-1], out["spacing"][:-1]))
    return {"rgb_loss": torch.mean((out["rgb"] - gt_rgb) ** 2),
            "interlevel_loss": v["interlevel_loss_mult"] * inter,
            "distortion_loss": v["distortion_loss_mult"] * distortion(w, ss, se)}


def render_image(P, v, cam1, height, width, precision=None):
    """One eval image of camera `cam1` (a dict of one camera) in chunks of
    eval_num_rays_per_chunk rays -> rgb (H, W, 3), depth, accumulation."""
    dev = cam1["c2w"].device
    ys, xs = torch.meshgrid(torch.arange(height, device=dev),
                            torch.arange(width, device=dev), indexing="ij")
    ys, xs = ys.reshape(-1), xs.reshape(-1)
    parts = []
    with torch.no_grad():
        for i in range(0, ys.shape[0], v["eval_num_rays_per_chunk"]):
            px, py = xs[i:i + v["eval_num_rays_per_chunk"]], ys[i:i + v["eval_num_rays_per_chunk"]]
            cam = torch.zeros_like(px)
            o, d = camera_rays(cam1, cam, px, py)
            out = vision_forward(P, v, o, d, cam, False, precision)
            parts.append((out["rgb"], out["depth"], out["accumulation"]))
    rgb, depth, acc = (torch.cat(p) for p in zip(*parts))
    return {"rgb": rgb.reshape(height, width, 3), "depth": depth.reshape(height, width),
            "accumulation": acc.reshape(height, width)}


# ------------------------------------------------------------ grid, bake

def cell_centers(res: int, device=None):
    axis = torch.arange(res, dtype=torch.float64, device=device) / res + 0.5 / res
    g = torch.stack(torch.meshgrid(axis, axis, axis, indexing="ij"), -1)
    return g.reshape(-1, 3).float()


def viewing_directions(device=None):
    """NeRAF's 18 bake directions (3 elevations x 6 azimuths), with x and y
    both cos(phi) sin(theta), as NeRAF writes them."""
    d = [[math.cos(p) * math.sin(t), math.cos(p) * math.sin(t), math.sin(t)]
         for p in (math.pi / 3, 0.0, -math.pi) for t in (k * math.pi / 3 for k in range(6))]
    return torch.tensor(d, dtype=torch.float32, device=device)


def bake(P, v, cells, aabb, precision=None, prefix="vision_model."):
    """Cells (B, 3) of the unit cube -> (B, 4) rgb + alpha, each the mean
    of the field over the 18 directions at the cell's world position."""
    world = cells * (aabb[1] - aabb[0]) + aabb[0]
    dirs = viewing_directions(cells.device)
    nd, n = dirs.shape[0], cells.shape[0]
    pos = world[None].expand(nd, n, 3).reshape(-1, 3)
    dd = dirs[:, None].expand(nd, n, 3).reshape(-1, 3)
    cam = torch.zeros(pos.shape[0], dtype=torch.long, device=cells.device)
    density, rgb = main_field(P, prefix, v, pos, dd, cam, False, True, precision)
    rgb = rgb.reshape(nd, n, 3).mean(0)
    alpha = (1.0 - torch.exp(-1e-2 * density.reshape(nd, n).mean(0))).clamp(0.0, 1.0)
    return torch.cat([rgb, alpha[:, None]], -1)


# ------------------------------------------------------------ 3D ResNet

def _bn(P, name, x, train, stats):
    w, b = P[f"{name}.weight"], P[f"{name}.bias"]
    shape = (1, -1, 1, 1, 1)
    if not train:
        mul = torch.rsqrt(stats[f"{name}.running_var"] + BN_EPS) * w
        return (x - stats[f"{name}.running_mean"].view(shape)) * mul.view(shape) + b.view(shape)
    mean = x.mean(dim=(0, 2, 3, 4))
    var = x.var(dim=(0, 2, 3, 4), unbiased=False)
    y = (x - mean.view(shape)) * torch.rsqrt(var + BN_EPS).view(shape) * w.view(shape) + b.view(shape)
    if stats is not None:
        for k, val in (("running_mean", mean), ("running_var", var)):
            stats[f"{name}.{k}"] = torch.lerp(stats[f"{name}.{k}"], val.detach(), BN_MOMENTUM)
    return y


def resnet(P, spec, vol, train, stats, precision=None, prefix="resnet."):
    """NDHWC volume (1, D, H, W, 7) -> (feature_dim,): conv 5^3 / 2, BN,
    ReLU, max pool 3 / 2, the residual stages, the mean over the volume.
    Train mode normalises with the batch statistics and moves `stats`
    (flax: momentum 0.9 towards the biased variance); eval mode reads them."""
    x = vol.permute(0, 4, 1, 2, 3)
    x = conv3d(x, P[f"{prefix}conv1.weight"], 2, 2, precision)
    x = F.relu(_bn(P, f"{prefix}bn1", x, train, stats))
    x = F.max_pool3d(x, 3, 2, 1)
    for name, _, _, stride, bottleneck, down in resnet_stages(spec):
        p = f"{prefix}{name}"
        if bottleneck:
            h = F.relu(_bn(P, f"{p}.bn1", conv3d(x, P[f"{p}.conv1.weight"], 1, 0, precision), train, stats))
            h = F.relu(_bn(P, f"{p}.bn2", conv3d(h, P[f"{p}.conv2.weight"], stride, 1, precision), train, stats))
            h = _bn(P, f"{p}.bn3", conv3d(h, P[f"{p}.conv3.weight"], 1, 0, precision), train, stats)
        else:
            h = F.relu(_bn(P, f"{p}.bn1", conv3d(x, P[f"{p}.conv1.weight"], stride, 1, precision), train, stats))
            h = _bn(P, f"{p}.bn2", conv3d(h, P[f"{p}.conv2.weight"], 1, 1, precision), train, stats)
        res = x
        if down:
            res = _bn(P, f"{p}.down_bn", conv3d(x, P[f"{p}.down_conv.weight"], stride, 0, precision), train, stats)
        x = F.relu(h + res)
    return x.mean(dim=(2, 3, 4))[0]


# -------------------------------------------------------- acoustic field

def _unit_box(pos, aabb):
    n = (pos - aabb[0]) / (aabb[1] - aabb[0])
    return n * torch.all((n > 0.0) & (n < 1.0), dim=-1)[..., None]


def audio_field(P, a, feature, time_query, mic, src, rot, aabb, precision=None,
                prefix="audio_model.field."):
    """(B,) time bins and (B, 3) poses with the scene feature -> (B, C, F)
    log-magnitudes: LeakyReLU(0.1) trunk, tanh(.) * 10 heads."""
    t = time_query.float()[..., None] / float(a["max_len"] - 1)
    h = torch.cat([nerf_encoding(t, 10), nerf_encoding(_unit_box(mic, aabb), 10),
                   nerf_encoding(_unit_box(src, aabb), 10), sh_encoding(rot)], -1)
    h = torch.cat([feature[None].expand(h.shape[0], -1), h], -1)
    for i in range(len(a["trunk"]) + 1):
        h = F.leaky_relu(linear(h, P[f"{prefix}trunk.{i}.weight"],
                                P[f"{prefix}trunk.{i}.bias"], precision), 0.1)
    return torch.stack([torch.tanh(linear(h, P[f"{prefix}heads.{c}.weight"],
                                          P[f"{prefix}heads.{c}.bias"], precision)) * 10.0
                        for c in range(a["mic_ch"])], -2)


def audio_losses(a, pred, gt):
    """SC (x 0.1) on magnitudes exp(x) - 1e-3 and the log-magnitude MSE,
    both times loss_factor."""
    xm, ym = torch.exp(pred) - 1e-3, torch.exp(gt) - 1e-3
    sc = torch.sqrt(((ym - xm) ** 2).sum()) / torch.sqrt((ym ** 2).sum())
    return {"audio_sc_loss": sc * 0.1 * a["loss_factor"],
            "audio_mag_loss": torch.mean((gt - pred) ** 2) * a["loss_factor"]}


def _window(a, device):
    n = torch.arange(a["win_len"], dtype=torch.float64)
    w = 0.5 * (1.0 - torch.cos(2.0 * math.pi * n / a["win_len"]))
    left = (a["n_fft"] - a["win_len"]) // 2
    return F.pad(w, (left, a["n_fft"] - a["win_len"] - left)).float().to(device)


def _istft(a, spec, length):
    spec = spec.clone()
    spec[..., 0, :].imag.zero_()
    spec[..., a["n_fft"] // 2, :].imag.zero_()
    out = torch.istft(spec.reshape(-1, *spec.shape[-2:]), a["n_fft"], a["hop_len"],
                      win_length=a["n_fft"], window=_window(a, spec.device),
                      center=True, normalized=False, onesided=True, length=length)
    return out.reshape(*spec.shape[:-2], length)


def stft(a, x):
    s = torch.stft(x.reshape(-1, x.shape[-1]), a["n_fft"], a["hop_len"],
                   win_length=a["n_fft"], window=_window(a, x.device), center=True,
                   pad_mode="reflect", normalized=False, onesided=True,
                   return_complex=True)
    return s.reshape(*x.shape[:-1], *s.shape[-2:])


def griffin_lim(a, mag, angles, n_iter=32, momentum=0.99):
    """torchaudio's Griffin-Lim (momentum / (1 + momentum)) from the given
    unit phasors -> (..., hop (T - 1)) waveforms."""
    length = a["hop_len"] * (mag.shape[-1] - 1)
    mom = momentum / (1.0 + momentum)
    ang, prev = angles, torch.zeros_like(angles)
    for _ in range(n_iter):
        rebuilt = stft(a, _istft(a, mag * ang, length))
        new = rebuilt - mom * prev
        ang = new / new.abs().clamp_min(1e-16)
        prev = rebuilt
    return _istft(a, mag * ang, length)


def render_waveforms(P, stats, a, grid_volume, mic, src, rot, aabb, angles,
                     precision=None, rows=8192):
    """One RIR request: the grid feature (eval-mode ResNet), every STFT
    frame of every pose through the field, clip(exp(x) - 1e-3, 0, 1e4),
    Griffin-Lim from `angles` -> (N, C, hop (T - 1)) waveforms and the
    (N, C, F, T) magnitudes they were recovered from."""
    with torch.no_grad():
        feat = resnet(P, a, grid_volume, False, stats, precision)
        N, T = mic.shape[0], a["max_len"]
        tq = torch.arange(T, device=mic.device).repeat(N)
        rep = lambda z: z.repeat_interleave(T, 0)
        m, s, r = rep(mic), rep(src), rep(rot)
        log = torch.cat([audio_field(P, a, feat, tq[i:i + rows], m[i:i + rows],
                                     s[i:i + rows], r[i:i + rows], aabb, precision)
                         for i in range(0, tq.shape[0], rows)])
        log = log.reshape(N, T, a["mic_ch"], a["n_freq_stft"]).permute(0, 2, 3, 1)
        mag = torch.clamp(torch.exp(log) - 1e-3, 0.0, 1e4)
        return griffin_lim(a, mag, angles), mag


# --------------------------------------------------------------- training

def lr_schedule(g: dict, count: int) -> float:
    """nerfstudio's ExponentialDecayScheduler with a cosine warmup, in
    float32, at the group's update count."""
    f32 = np.float32
    step = f32(count)
    if step < g["warmup_steps"]:
        frac = np.sin(f32(0.5 * np.pi) * np.clip(step / f32(g["warmup_steps"]), f32(0), f32(1)))
        return float(f32(1e-8) + f32(g["lr"] - 1e-8) * frac)
    t = np.clip((step - f32(g["warmup_steps"])) / f32(max(g["max_steps"] - g["warmup_steps"], 1)),
                f32(0), f32(1))
    return float(np.exp(np.log(f32(g["lr"])) * (f32(1) - t) + np.log(f32(g["lr_final"])) * t))


def adam_groups(names) -> dict:
    """The four Adam groups of the joint step; the vision field is in both
    `fields` and `audio_fields`."""
    field = [n for n in names if n.startswith("vision_model.field.")]
    return {
        "proposal_networks": [n for n in names if n.startswith("vision_model.proposal_networks.")],
        "fields": field,
        "camera_opt": [n for n in names if n == "vision_model.camera_opt"],
        "audio_fields": [n for n in names if n.startswith(("audio_model.", "resnet."))] + field,
    }


def anneal(step: int) -> float:
    frac = np.clip(np.float32(step) / np.float32(1000.0), 0.0, 1.0)
    return float(np.float32(10.0) * frac / (np.float32(9.0) * frac + np.float32(1.0)))


class JointState:
    """The reference's training state: leaves, BatchNorm statistics, Adam
    moments and counts, grid, cursor and step."""

    def __init__(self, weights: dict, spec: dict, grid, cursor: int, step: int,
                 count: int):
        self.P = {k: t.detach().clone().requires_grad_()
                  for k, t in weights.items() if not k.endswith(("running_mean", "running_var"))}
        self.stats = {k: t.detach().clone() for k, t in weights.items()
                      if k.endswith(("running_mean", "running_var"))}
        self.groups = adam_groups(list(self.P))
        self.moments = {g: {} for g in self.groups}
        self.counts = {g: count for g in self.groups}
        self.grid, self.cursor, self.step = grid.clone(), cursor, step
        self.spec = spec


def joint_step(st: JointState, cams, images, audio, draws, aabbs, precision=None):
    """One joint step from `draws` (cam, py, px, rec, t, u_init, u_pdf0,
    u_pdf1) -> ({loss: float}, {leaf: gradient}). Updates st in place."""
    spec, v, a, tr = st.spec, st.spec["vision"], st.spec["audio"], st.spec["trainer"]
    P = st.P
    cam, py, px = draws["cam"], draws["py"], draws["px"]
    origins, directions = camera_rays(cams, cam, px, py)
    gt_rgb = images[cam, py, px]
    active = st.step > tr["start_step_audio"]
    jit = [draws[k].float().reshape(cam.shape[0], -1) for k in ("u_init", "u_pdf0", "u_pdf1")]
    out = vision_forward(P, v, origins, directions, cam, True, precision,
                         anneal(st.step), jit)
    losses = vision_losses(v, out, gt_rgb)
    n = tr["grid_bake_cells_per_step"]
    cells = cell_centers(a["grid_res"], origins.device)[st.cursor:st.cursor + n]
    fresh = bake(P, v, cells, aabbs["vision"], precision)
    grid = st.grid.detach().clone()
    grid[st.cursor:st.cursor + n, :4] = fresh
    R = a["grid_res"]
    stats = st.stats if active else None
    feat = resnet(P, a, grid.reshape(1, R, R, R, GRID_CHANNELS), True, stats, precision)
    rec, t = draws["rec"], draws["t"]
    pred = audio_field(P, a, feat, t, audio["mic_pose"][rec], audio["source_pose"][rec],
                       audio["rot"][rec], aabbs["audio"], precision)
    gt = audio["log_stft"][rec, :, :, t]
    mask = 1.0 if active else 0.0
    for k, val in audio_losses(a, pred, gt).items():
        losses[k] = val * mask
    total = sum(losses.values())
    names = list(P)
    grads = dict(zip(names, torch.autograd.grad(total, [P[k] for k in names],
                                                allow_unused=True)))
    grads = {k: torch.zeros_like(P[k]) if g is None else g for k, g in grads.items()}
    b1, b2 = ADAM_BETAS
    with torch.no_grad():
        for g_name, members in st.groups.items():
            cfg = spec["optimizers"][g_name]
            lr = lr_schedule(cfg, st.counts[g_name])
            for k in members:
                m, vv, step = st.moments[g_name].get(k, (torch.zeros_like(P[k]),
                                                         torch.zeros_like(P[k]), 0))
                step += 1
                m = b1 * m + (1 - b1) * grads[k]
                vv = b2 * vv + (1 - b2) * grads[k] ** 2
                denom = vv.sqrt() / math.sqrt(1 - b2 ** step) + cfg["eps"]
                P[k] -= (lr / (1 - b1 ** step)) * m / denom
                st.moments[g_name][k] = (m, vv, step)
            st.counts[g_name] += 1
        grid[st.cursor:st.cursor + n, :4] = fresh.detach()
    st.grid = grid.detach()
    st.cursor = (st.cursor + n) % st.grid.shape[0]
    st.step += 1
    return {k: float(val.detach()) for k, val in losses.items()}, grads
