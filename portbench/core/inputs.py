"""Everything a run feeds the program, made on the device from --seed:
the weights (one normal draw for all of them, scaled by kind), the scene
grid, cameras and the requests' poses. The same seed gives the same inputs; the
reference reads the same tensors.
"""

from __future__ import annotations

import hashlib
import math

import torch

from portbench.reference import neraf as ref


def key(seed: int, *parts) -> int:
    """A 63-bit generator seed for one stream of a run's inputs."""
    h = hashlib.sha256(repr((int(seed), *parts)).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(device, seed: int, *parts) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(key(seed, *parts))


def make_weights(shapes: dict, seed: int, device) -> dict:
    """{name: float32 tensor} from one normal draw on the device: weight
    matrices and kernels N(0, 1 / fan_in); biases N(0, 0.05^2); BatchNorm
    scale 1 + N(0, 0.1^2), shift, running mean N(0, 0.1^2), running
    variance exp(N(0, 0.1^2)); the hash table N(0, 0.1^2); appearance
    embeddings N(0, 1 / dim); camera corrections N(0, 1e-3^2); the acoustic
    heads' biases -0.3 (log-magnitudes near tanh(-0.3) 10 = -2.9); the
    colour head's ReLU layers N(0, 2 / fan_in) and its output N(0, 16 /
    fan_in), so that its logits are of order 1 and colours span most of
    [0, 1], as a trained field's do (with 1 / fan_in an image is grey to
    within 0.05, and its colour errors drown in the rounding of the
    output)."""
    total = sum(math.prod(s) for s in shapes.values())
    z = torch.randn(total, generator=generator(device, seed, "weights"),
                    device=device)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        t = z[off:off + n].view(shape)
        off += n
        leaf = name.rsplit(".", 1)[-1]
        owner = name.split(".")[-2] if "." in name else ""
        norm = owner.startswith("bn") or owner.endswith("_bn")
        if leaf == "running_var":
            t = torch.exp(0.1 * t)
        elif leaf == "running_mean" or (norm and leaf == "bias"):
            t = 0.1 * t
        elif norm and leaf == "weight":
            t = 1.0 + 0.1 * t
        elif leaf == "table":
            t = 0.1 * t
        elif leaf == "camera_opt":
            t = 1e-3 * t
        elif name.endswith("appearance.weight"):
            t = t / math.sqrt(shape[1])
        elif ".heads." in name and leaf == "bias":
            t = torch.full(shape, -0.3, device=device)
        elif leaf == "bias":
            t = 0.05 * t
        elif ".mlp_head." in name:
            t = t * math.sqrt(2.0 / math.prod(shape[1:]))
        elif ".head_out." in name:
            t = t * (4.0 / math.sqrt(math.prod(shape[1:])))
        else:
            t = t / math.sqrt(math.prod(shape[1:]))
        out[name] = t.contiguous()
    return out


def load_weights(module: torch.nn.Module, weights: dict, prefix: str) -> None:
    """Copy weights[prefix + name] into every parameter and BatchNorm
    statistic of module; KeyError or ValueError if the two sets of names
    or shapes differ (the program's model is not the configuration's)."""
    own = {k: v for k, v in module.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    want = {k[len(prefix):]: v for k, v in weights.items() if k.startswith(prefix)}
    if set(own) != set(want):
        raise KeyError(f"{prefix}: the program has {sorted(set(own) - set(want))[:5]} "
                       f"beyond the configuration, lacks {sorted(set(want) - set(own))[:5]}")
    with torch.no_grad():
        for k, t in own.items():
            if tuple(t.shape) != tuple(want[k].shape):
                raise ValueError(f"{prefix}{k}: program {tuple(t.shape)}, "
                                 f"configuration {tuple(want[k].shape)}")
            t.copy_(want[k])


def grid(res: int, seed: int, device) -> torch.Tensor:
    """(R^3, 7) scene grid: rgb and alpha uniform in [0, 1], then the cell
    centres."""
    g = torch.rand((res ** 3, 4), generator=generator(device, seed, "grid"),
                   device=device)
    return torch.cat([g, ref.cell_centers(res, device)], -1).contiguous()


def look_at(positions: torch.Tensor, yaw: torch.Tensor, pitch: torch.Tensor):
    """(N, 3, 4) OpenGL camera-to-world (-z forward, z up) looking along
    (cos p cos y, cos p sin y, sin p)."""
    fwd = torch.stack([torch.cos(pitch) * torch.cos(yaw),
                       torch.cos(pitch) * torch.sin(yaw), torch.sin(pitch)], -1)
    up0 = torch.tensor([0.0, 0.0, 1.0], device=positions.device).expand_as(fwd)
    right = torch.linalg.cross(fwd, up0)
    right = right / torch.linalg.norm(right, dim=-1, keepdim=True)
    up = torch.linalg.cross(right, fwd)
    return torch.stack([right, up, -fwd, positions], -1)


def cameras(n: int, gen: torch.Generator, box: float, pitch_deg: float,
            focal: float, height: int, width: int) -> dict:
    """n pinhole cameras, positions uniform in [-box, box]^3, yaw uniform,
    pitch uniform in +-pitch_deg; fx = fy = focal, the principal point at
    the image centre."""
    dev = gen.device
    pos = (torch.rand((n, 3), generator=gen, device=dev) * 2.0 - 1.0) * box
    yaw = torch.rand(n, generator=gen, device=dev) * (2.0 * math.pi)
    pitch = (torch.rand(n, generator=gen, device=dev) * 2.0 - 1.0) * math.radians(pitch_deg)
    full = lambda v: torch.full((n,), float(v), device=dev)
    return {"c2w": look_at(pos, yaw, pitch).contiguous(), "fx": full(focal),
            "fy": full(focal), "cx": full(width / 2), "cy": full(height / 2)}


def poses(n: int, gen: torch.Generator, aabb, azimuths_deg) -> tuple:
    """n (mic, source, orientation): positions uniform inside the audio
    AABB, the orientation one of the azimuths as NeRAF encodes it,
    ([cos a, 0, sin a] + 1) / 2."""
    dev = gen.device
    lo = torch.tensor(aabb[0], device=dev)
    hi = torch.tensor(aabb[1], device=dev)
    u = torch.rand((2, n, 3), generator=gen, device=dev) * 0.98 + 0.01
    mic, src = lo + u * (hi - lo)
    az = torch.tensor([math.radians(a) for a in azimuths_deg], device=dev)
    a = az[torch.randint(0, az.numel(), (n,), generator=gen, device=dev)]
    rot = (torch.stack([torch.cos(a), torch.zeros_like(a), torch.sin(a)], -1) + 1.0) / 2.0
    return mic.contiguous(), src.contiguous(), rot.contiguous()
