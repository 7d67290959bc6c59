"""LPIPS perceptual distance (counterpart of neraf_tpu/metrics/lpips_impl.py).

LPIPS (Zhang et al., CVPR 2018), as torchmetrics' metric that the
reference's Nerfacto eval reports (NeRAF_pipeline.py:328): both images
through a frozen ImageNet backbone (AlexNet or VGG16 `features`, with
torchvision's layer indexing), each of five taps unit-normalised across
channels, squared differences weighted by a learned non-negative 1x1 head,
averaged over space and summed over the taps.

The backbones are F.conv2d / F.max_pool2d calls (cuDNN's convolutions on
a card, as the JAX package's are XLA's lax.conv), run in float32 with
TF32 off for cuDNN: TF32 would move the metric by ~1e-3 relative.

No weights ship (no download here). Convert once, on a machine that has
the checkpoints, with params_from_torch_state_dicts (torchvision's
`features.{i}.*`, the lpips package's `lin{j}.model.1.weight` heads, or a
whole `LPIPS.state_dict()` with `net.slice{k}.{i}.*`), save_params_npz,
then set NERAF_LPIPS_WEIGHTS to the file or put it at
~/.cache/neraf/lpips_{alex,vgg}.npz. The .npz is the JAX package's format:
either package reads the other's.
"""

from __future__ import annotations

import functools
import os
import re
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

# torchvision `features` conv indices and the layer after whose ReLU each
# LPIPS tap is taken (lpips/pretrained_networks.py's slices)
_ALEX_CONVS = {
    0: dict(cin=3, cout=64, k=11, stride=4, pad=2),
    3: dict(cin=64, cout=192, k=5, stride=1, pad=2),
    6: dict(cin=192, cout=384, k=3, stride=1, pad=1),
    8: dict(cin=384, cout=256, k=3, stride=1, pad=1),
    10: dict(cin=256, cout=256, k=3, stride=1, pad=1),
}
_ALEX_POOLS = {2: (3, 2), 5: (3, 2), 12: (3, 2)}  # idx -> (kernel, stride)
_VGG_CONV_IDXS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_VGG_COUTS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)
_VGG_CONVS = {
    idx: dict(cin=3 if i == 0 else _VGG_COUTS[i - 1], cout=_VGG_COUTS[i],
              k=3, stride=1, pad=1)
    for i, idx in enumerate(_VGG_CONV_IDXS)}
_VGG_POOLS = {4: (2, 2), 9: (2, 2), 16: (2, 2), 23: (2, 2), 30: (2, 2)}

_NETS = {
    "alex": dict(convs=_ALEX_CONVS, pools=_ALEX_POOLS, taps=(1, 4, 7, 9, 11),
                 channels=(64, 192, 384, 256, 256), min_size=32),
    "vgg": dict(convs=_VGG_CONVS, pools=_VGG_POOLS, taps=(3, 8, 15, 22, 29),
                channels=(64, 128, 256, 512, 512), min_size=16),
}

# the lpips ScalingLayer: ImageNet mean and std for inputs in [-1, 1]
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def init_params(net: str, seed: int = 0) -> dict:
    """Random weights with the pretrained checkpoints' shapes (tests, and
    the converter's shape spec): conv weights normal / sqrt(fan_in), biases
    normal * 0.01, heads |normal| / channels."""
    spec = _NETS[net]
    gen = torch.Generator().manual_seed(seed)
    randn = lambda *shape: torch.randn(shape, generator=gen)
    params = {}
    for idx, c in spec["convs"].items():
        fan_in = c["cin"] * c["k"] * c["k"]
        params[f"conv{idx}.w"] = (randn(c["cout"], c["cin"], c["k"], c["k"])
                                  / np.sqrt(fan_in)).numpy()
        params[f"conv{idx}.b"] = (randn(c["cout"]) * 0.01).numpy()
    for i, ch in enumerate(spec["channels"]):
        params[f"lin{i}.w"] = (randn(ch).abs() / ch).numpy()
    return params


def _features(params: dict, x: torch.Tensor, net: str) -> list:
    """The backbone's five tap feature maps of x (N, 3, H, W)."""
    spec = _NETS[net]
    taps = []
    for idx in range(max(spec["taps"]) + 1):
        if idx in spec["convs"]:
            c = spec["convs"][idx]
            x = F.conv2d(x, params[f"conv{idx}.w"], params[f"conv{idx}.b"],
                         stride=c["stride"], padding=c["pad"])
        elif idx in spec["pools"]:
            k, s = spec["pools"][idx]
            x = F.max_pool2d(x, k, s)
        else:  # every other index of both stacks is a ReLU
            x = F.relu(x)
        if idx in spec["taps"]:
            taps.append(x)
    return taps


def _unit_normalize(feat: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """lpips.normalize_tensor: x / (||x|| over channels + eps)."""
    return feat / (torch.sqrt(torch.sum(feat ** 2, dim=1, keepdim=True)) + eps)


def _as_tensors(params: dict, device) -> dict:
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                               dtype=torch.float32, device=device)
            for k, v in params.items()}


@functools.lru_cache(maxsize=8)
def _scaling(device: torch.device) -> tuple:
    """The ScalingLayer's shift and scale as (1, 3, 1, 1) tensors on
    `device`, made once (a host-to-device copy a call would stall it)."""
    return tuple(torch.tensor(v, dtype=torch.float32)[None, :, None, None]
                 .to(device) for v in (_SHIFT, _SCALE))


def _scaled(img: torch.Tensor, normalize: bool) -> torch.Tensor:
    """(N, H, W, 3) images -> the backbone's (N, 3, H, W) float32 input."""
    x = img.to(torch.float32).permute(0, 3, 1, 2)
    if normalize:
        x = 2.0 * x - 1.0
    shift, scale = _scaling(x.device)
    return (x - shift) / scale


def _taps(params: dict, x: torch.Tensor, net: str,
          allow_tf32: bool = False) -> list:
    """_features with cuDNN's TF32 set as given (off for the metric), then
    restored."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = allow_tf32
    try:
        return _features(params, x, net)
    finally:
        torch.backends.cudnn.allow_tf32 = before


def _distance(fx: list, fy: list, params: dict) -> torch.Tensor:
    """The five taps of each image -> (N,) distances: unit-normalised over
    channels, squared differences weighted by the heads, averaged over
    space, summed over the taps."""
    total = torch.zeros((fx[0].shape[0],), dtype=torch.float32,
                        device=fx[0].device)
    for i, (a, b) in enumerate(zip(fx, fy)):
        d = (_unit_normalize(a) - _unit_normalize(b)) ** 2
        w = params[f"lin{i}.w"][None, :, None, None]
        total = total + torch.mean(torch.sum(d * w, dim=1), dim=(1, 2))
    return total


@torch.no_grad()
def lpips_distance(params: dict, pred, target, net: str = "alex",
                   normalize: bool = True) -> torch.Tensor:
    """LPIPS(pred, target) of (H, W, 3) images -> a scalar, or of
    (N, H, W, 3) batches -> (N,), on pred's device. The images are in
    [0, 1] with normalize=True (torchmetrics' convention, the reference's),
    else in [-1, 1]; `params` as params_from_torch_state_dicts gives them
    (numpy arrays or tensors). Images under the backbone's minimum side
    (alex 32, vgg 16), whose last taps would be empty, raise ValueError.
    Both images go through the backbone as one batch."""
    pred = torch.as_tensor(pred)
    target = torch.as_tensor(target, device=pred.device)
    batched = pred.ndim == 4
    if not batched:
        pred, target = pred[None], target[None]
    min_size = _NETS[net]["min_size"]
    if min(pred.shape[1], pred.shape[2]) < min_size:
        raise ValueError(f"LPIPS({net}) needs images >= {min_size}px per "
                         f"side, got {tuple(pred.shape[1:3])}")
    p = _as_tensors(params, pred.device)
    n = pred.shape[0]
    taps = _taps(p, _scaled(torch.cat([pred, target]), normalize), net)
    total = _distance([t[:n] for t in taps], [t[n:] for t in taps], p)
    return total if batched else total[0]


# ---------------------------------------------------------------------------
# Weight conversion / IO
# ---------------------------------------------------------------------------

_KEY_RE = re.compile(r"(?:net\.slice\d+|features)\.(\d+)\.(weight|bias)$")
_LIN_RE = re.compile(r"lins?\.?(\d)\.model\.1\.weight$")


def params_from_torch_state_dicts(state_dicts, net: str = "alex") -> dict:
    """torch checkpoints -> the flat {conv{i}.w, conv{i}.b, lin{j}.w} dict
    of numpy arrays. Takes any mix of torchvision backbone state dicts
    (`features.{i}.*`), whole `lpips.LPIPS.state_dict()` saves
    (`net.slice{k}.{i}.*` and `lin{j}.model.1.weight`) and the lpips
    package's head files (`lin{j}.model.1.weight`); later dicts win.
    ValueError names what is missing."""
    spec = _NETS[net]
    params = {}
    for sd in state_dicts:
        for key, val in sd.items():
            arr = (val.detach().cpu().numpy() if torch.is_tensor(val)
                   else np.asarray(val)).astype(np.float32)
            m = _KEY_RE.search(key)
            if m:
                idx, kind = int(m.group(1)), m.group(2)
                if idx in spec["convs"]:
                    params[f"conv{idx}.{'w' if kind == 'weight' else 'b'}"] = arr
                continue
            m = _LIN_RE.search(key)
            if m:
                params[f"lin{int(m.group(1))}.w"] = arr.reshape(-1)
    missing = _missing_keys(params, net)
    if missing:
        raise ValueError(f"LPIPS conversion incomplete for net={net}; "
                         f"missing: {missing}")
    return params


def _missing_keys(params: dict, net: str) -> list:
    spec = _NETS[net]
    want = [f"conv{i}.{s}" for i in spec["convs"] for s in ("w", "b")]
    want += [f"lin{i}.w" for i in range(len(spec["channels"]))]
    return [k for k in want if k not in params]


def save_params_npz(path, params: dict, net: str) -> None:
    path = Path(path).expanduser()
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, __net__=np.asarray(net),
             **{k: np.asarray(v) for k, v in params.items()})


@functools.lru_cache(maxsize=4)
def load_params(path: str) -> tuple:
    """(params, net) from a converted .npz, or from a torch .pt / .pth
    state dict (torch.load with weights_only=True; alex, else vgg)."""
    p = Path(path).expanduser()
    if p.suffix == ".npz":
        with np.load(p) as z:
            net = str(z["__net__"]) if "__net__" in z else "alex"
            params = {k: z[k] for k in z.files if k != "__net__"}
    else:
        sd = torch.load(p, map_location="cpu", weights_only=True)
        try:
            params, net = params_from_torch_state_dicts([sd], net="alex"), "alex"
        except ValueError:
            params, net = params_from_torch_state_dicts([sd], net="vgg"), "vgg"
    missing = _missing_keys(params, net)
    if missing:
        raise ValueError(f"LPIPS weights at {path} incomplete: missing {missing}")
    return params, net


@functools.lru_cache(maxsize=4)
def load_device_params(path: str, device: str) -> tuple:
    """load_params with the weights as float32 tensors on `device`, kept
    across calls (an eval sweep measures every view with them)."""
    params, net = load_params(path)
    return _as_tensors(params, torch.device(device)), net


_DEFAULT_PATHS = (
    "~/.cache/neraf/lpips_alex.npz",
    "~/.cache/neraf/lpips_vgg.npz",
)


def resolve_default_weights() -> str | None:
    """NERAF_LPIPS_WEIGHTS if that file exists, else the first default
    cache path that does, else None."""
    env = os.environ.get("NERAF_LPIPS_WEIGHTS")
    if env and Path(env).expanduser().exists():
        return env
    for cand in _DEFAULT_PATHS:
        if Path(cand).expanduser().exists():
            return cand
    return None
