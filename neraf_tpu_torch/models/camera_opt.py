"""SO3xR3 camera-pose correction (counterpart of
neraf_tpu/models/camera_opt.py): a learned 6-DoF tangent-space correction
per training camera, [omega (3), translation (3)], zero-initialised,
applied to ray directions (rotation by the SO(3) exponential map) and
origins (translation).
"""

from __future__ import annotations

import torch


def exp_map_so3(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula: (..., 3) axis-angle -> (..., 3, 3) rotation.

    The norm is taken of a clamped sum of squares, so the gradient at the
    zero-initialised correction is 0 and not NaN; below 1e-7 rad the
    rotation is I + K."""
    sq = torch.sum(omega * omega, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(sq.clamp_min(1e-16))
    zero = torch.zeros_like(omega[..., 0])
    wx, wy, wz = omega.unbind(-1)
    K = torch.stack([
        torch.stack([zero, -wz, wy], dim=-1),
        torch.stack([wz, zero, -wx], dim=-1),
        torch.stack([-wy, wx, zero], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(K.shape)
    theta_safe = theta.clamp_min(1e-8)
    A = torch.sin(theta_safe) / theta_safe
    B = (1.0 - torch.cos(theta_safe)) / theta_safe ** 2
    R = eye + A * K + B * (K @ K)
    return torch.where(theta < 1e-7, eye + K, R)


def apply_camera_opt(cam_params: torch.Tensor, camera_indices: torch.Tensor,
                     origins: torch.Tensor, directions: torch.Tensor):
    """Per-camera corrections (N, 6) applied to a ray batch (B, 3) each."""
    corr = cam_params[camera_indices]
    R = exp_map_so3(corr[..., :3])
    new_dirs = torch.einsum("bij,bj->bi", R, directions)
    return origins + corr[..., 3:], new_dirs
