"""The vision data stack (counterpart of neraf_tpu/data/vision_data.py):
a Nerfstudio-format scene (transforms.json and its images) loaded with the
reference's pose preprocessing (orient the mean up-vector to +z, centre on
the mean camera position, scale into the unit box) and its 'fraction' and
'filename' eval splits; camera arrays, ray generation and pixel sampling.
`camera_arrays` takes a CameraSet or any object with its fields (c2w
(N, 3, 4), fx, fy, cx, cy (N,), distortion (N, 6), numpy arrays). The pose
math runs in float64, as in the JAX package; the cameras are float32.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from neraf_tpu_torch.utils.png import read_rgb, resize_bilinear


@dataclasses.dataclass
class CameraSet:
    """Per-frame pinhole cameras (OpenGL convention: -z forward, y up)."""

    c2w: np.ndarray  # (N, 3, 4)
    fx: np.ndarray  # (N,)
    fy: np.ndarray
    cx: np.ndarray
    cy: np.ndarray
    width: int
    height: int
    distortion: np.ndarray  # (N, 6) k1 k2 k3 k4 p1 p2
    scale_factor: float = 1.0  # applied pose scale (dataparser_scale)

    def __len__(self):
        return self.c2w.shape[0]


@dataclasses.dataclass
class VisionDataset:
    cameras: CameraSet
    images: np.ndarray  # (N, H, W, 3) float32 in [0,1]
    indices: np.ndarray  # (N,) original frame indices
    aabb: np.ndarray  # (2, 3) scene box


def _auto_orient_and_center(poses: np.ndarray):
    """nerfstudio's auto_orient_and_center_poses(method='up',
    center='poses'): rotate the mean camera up-vector onto +z, centre on the
    mean camera position -> (oriented (N, 3, 4), the (3, 4) transform)."""
    translation = poses[:, :3, 3].mean(axis=0)

    up = poses[:, :3, 1].mean(axis=0)
    up = up / np.linalg.norm(up)
    target = np.array([0.0, 0.0, 1.0])

    v = np.cross(up, target)
    s = np.linalg.norm(v)
    c = float(np.dot(up, target))
    if s < 1e-8:
        rot = np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
    else:
        vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
        rot = np.eye(3) + vx + vx @ vx * ((1 - c) / (s**2))

    transform = np.concatenate([rot, rot @ -translation[:, None]], axis=1)  # (3,4)
    ones = np.tile(np.array([0, 0, 0, 1.0]), (poses.shape[0], 1, 1))
    poses_h = np.concatenate([poses[:, :3, :], ones], axis=1)
    oriented = np.einsum("ij,njk->nik", np.concatenate([transform, [[0, 0, 0, 1]]]), poses_h)
    return oriented[:, :3, :], transform


def _split_indices(frames: list, split: str, eval_mode: str,
                   train_split_fraction: float) -> np.ndarray:
    """'filename': frames whose file_path holds "train" are the train split
    (fraction splitting when none does); 'fraction': nerfstudio's evenly
    spaced train frames, the rest eval (the last train view when none is
    left)."""
    n = len(frames)
    if eval_mode == "filename":
        is_train = np.array(["train" in str(f["file_path"]) for f in frames])
        if is_train.any():
            return np.where(is_train if split == "train" else ~is_train)[0]
    num_train = int(np.ceil(n * train_split_fraction))
    train_idx = np.unique(np.linspace(0, n - 1, num_train, dtype=int))
    if split == "train":
        return train_idx
    idx = np.setdiff1d(np.arange(n), train_idx)
    return idx if idx.size else train_idx[-1:]


def load_transforms(
    data_dir: str | Path,
    split: str = "train",
    eval_mode: str = "fraction",
    train_split_fraction: float = 0.9,
    downscale_factor: int = 1,
) -> VisionDataset:
    """Load a Nerfstudio-format scene (transforms.json + images)."""
    data_dir = Path(data_dir)
    with open(data_dir / "transforms.json") as f:
        meta = json.load(f)
    frames = meta["frames"]

    def get(frame, key, default=0.0):
        return frame.get(key, meta.get(key, default))

    poses = np.array([f["transform_matrix"] for f in frames], dtype=np.float64)
    fx = np.array([get(f, "fl_x") for f in frames])
    fy = np.array([get(f, "fl_y") for f in frames])
    cx = np.array([get(f, "cx") for f in frames])
    cy = np.array([get(f, "cy") for f in frames])
    width = int(get(frames[0], "w", 0) or meta.get("w"))
    height = int(get(frames[0], "h", 0) or meta.get("h"))
    dist = np.array([
        [get(f, k) for k in ("k1", "k2", "k3", "k4", "p1", "p2")] for f in frames
    ])

    poses3, _ = _auto_orient_and_center(poses[:, :3, :])
    scale = 1.0 / max(float(np.max(np.abs(poses3[:, :3, 3]))), 1e-8)
    poses3 = poses3.copy()
    poses3[:, :3, 3] *= scale

    idx = _split_indices(frames, split, eval_mode, train_split_fraction)

    if downscale_factor > 1:
        fx, fy = fx / downscale_factor, fy / downscale_factor
        cx, cy = cx / downscale_factor, cy / downscale_factor
        width, height = width // downscale_factor, height // downscale_factor

    imgs = []
    for i in idx:
        img = read_rgb(data_dir / frames[i]["file_path"])
        if downscale_factor > 1:
            img = resize_bilinear(img, width, height)
        imgs.append(img.astype(np.float32) / 255.0)
    images = np.stack(imgs) if imgs else np.zeros((0, height, width, 3), np.float32)

    cameras = CameraSet(
        c2w=poses3[idx].astype(np.float32),
        fx=fx[idx].astype(np.float32), fy=fy[idx].astype(np.float32),
        cx=cx[idx].astype(np.float32), cy=cy[idx].astype(np.float32),
        width=width, height=height,
        distortion=dist[idx].astype(np.float32),
        scale_factor=scale,
    )
    aabb = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]])  # nerfstudio scene box
    return VisionDataset(cameras=cameras, images=images, indices=idx, aabb=aabb)


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
