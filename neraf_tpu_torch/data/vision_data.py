"""Camera arrays, ray generation and pixel sampling (counterpart of
neraf_tpu/data/vision_data.py:168-240). Loading transforms.json comes with
the data slice; `camera_arrays` takes any object with the CameraSet fields
(c2w (N, 3, 4), fx, fy, cx, cy (N,), distortion (N, 6), numpy arrays).
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch


def synthetic_cameras(n: int, height: int, width: int, hfov_deg: float = 90.0,
                      seed: int = 0) -> SimpleNamespace:
    """`n` pinhole cameras with the CameraSet fields, for runs without a
    scene: seeded positions in the [-1, 1]^3 scene box, seeded orientations,
    focal length from the horizontal field of view (SoundSpaces renders
    512 x 512 at 90 degrees: fx = fy = 256), no distortion."""
    rng = np.random.default_rng(seed)
    c2w = np.zeros((n, 3, 4), np.float32)
    for i in range(n):
        q, r = np.linalg.qr(rng.normal(size=(3, 3)))
        q = q * np.sign(np.diag(r))
        if np.linalg.det(q) < 0:
            q[:, 0] = -q[:, 0]
        c2w[i, :, :3], c2w[i, :, 3] = q, rng.uniform(-1.0, 1.0, 3)
    f = 0.5 * width / math.tan(math.radians(hfov_deg) / 2.0)
    full = lambda v: np.full(n, v, np.float32)
    return SimpleNamespace(c2w=c2w, fx=full(f), fy=full(f), cx=full(width / 2.0),
                           cy=full(height / 2.0),
                           distortion=np.zeros((n, 6), np.float32))


def camera_arrays(cams, device="cuda") -> dict:
    """Cameras as float32 tensors on `device`; the OPENCV distortion is
    included only when some camera has a nonzero coefficient."""
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    arrays = {k: as_t(getattr(cams, k)) for k in ("c2w", "fx", "fy", "cx", "cy")}
    if np.any(np.asarray(cams.distortion) != 0):
        arrays["distortion"] = as_t(cams.distortion)
    return arrays


def _undistort(x: torch.Tensor, y: torch.Tensor, d: torch.Tensor,
               iters: int = 10):
    """Invert the OPENCV distortion model by fixed-point iteration;
    d (B, 6) = (k1, k2, k3, k4, p1, p2)."""
    k1, k2, k3, k4, p1, p2 = d.unbind(-1)
    xu, yu = x, y
    for _ in range(iters):
        r2 = xu * xu + yu * yu
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)))
        dx_t = 2.0 * p1 * xu * yu + p2 * (r2 + 2.0 * xu * xu)
        dy_t = p1 * (r2 + 2.0 * yu * yu) + 2.0 * p2 * xu * yu
        xu = (x - dx_t) / radial
        yu = (y - dy_t) / radial
    return xu, yu


def generate_rays(cam_arrays: dict, cam_idx: torch.Tensor, px: torch.Tensor,
                  py: torch.Tensor) -> dict:
    """(B,) camera indices and pixel coordinates -> world rays (OpenGL
    camera, -z forward): origins (B, 3), unit directions (B, 3),
    camera_indices (B,)."""
    fx = cam_arrays["fx"][cam_idx]
    fy = cam_arrays["fy"][cam_idx]
    cx = cam_arrays["cx"][cam_idx]
    cy = cam_arrays["cy"][cam_idx]
    c2w = cam_arrays["c2w"][cam_idx]  # (B, 3, 4)

    x = (px.to(torch.float32) + 0.5 - cx) / fx  # pixel centres
    y = (py.to(torch.float32) + 0.5 - cy) / fy
    if "distortion" in cam_arrays:
        x, y = _undistort(x, y, cam_arrays["distortion"][cam_idx])
    dirs_cam = torch.stack([x, -y, -torch.ones_like(x)], dim=-1)
    dirs = torch.einsum("bij,bj->bi", c2w[:, :3, :3], dirs_cam)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    return {"origins": c2w[:, :3, 3], "directions": dirs,
            "camera_indices": cam_idx}


def sample_pixel_batch(num_cams: int, height: int, width: int,
                       batch_size: int, generator: torch.Generator,
                       device=None):
    """Uniform random (camera, y, x) pixel batch, each (B,) int64."""
    draw = lambda hi: torch.randint(0, hi, (batch_size,), generator=generator,
                                    device=device)
    return draw(num_cams), draw(height), draw(width)
