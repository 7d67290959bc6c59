"""Image metrics: PSNR, SSIM and LPIPS (counterpart of
neraf_tpu/metrics/image.py). LPIPS needs converted pretrained weights
(metrics/lpips_impl.py); without them it is NaN here, and the eval paths
report it as skipped (engine/pipeline.py), as the JAX package does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def psnr(pred: torch.Tensor, target: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio over images in [0, max_val]."""
    mse = torch.mean((pred - target) ** 2)
    return 20.0 * math.log10(max_val) - 10.0 * torch.log10(mse)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5,
                     device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(pred: torch.Tensor, target: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    """Gaussian-window SSIM (11 x 11, sigma 1.5, k1 0.01, k2 0.03, valid
    padding) of (H, W, C) images, with the variances clamped at 0 and the
    covariance to +-sqrt(var_p var_t)."""
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    kernel = _gaussian_kernel(device=pred.device)[None, None]

    def filt(img):  # (H, W, C) -> depthwise blur, valid padding
        y = F.conv2d(img.permute(2, 0, 1)[:, None], kernel)
        return y[:, 0].permute(1, 2, 0)

    mu_p, mu_t = filt(pred), filt(target)
    mu_pp, mu_tt, mu_pt = filt(pred * pred), filt(target * target), filt(pred * target)
    var_p = (mu_pp - mu_p ** 2).clamp_min(0.0)
    var_t = (mu_tt - mu_t ** 2).clamp_min(0.0)
    bound = torch.sqrt(var_p * var_t)
    cov = torch.minimum(torch.maximum(mu_pt - mu_p * mu_t, -bound), bound)
    s = ((2 * mu_p * mu_t + c1) * (2 * cov + c2)) / (
        (mu_p ** 2 + mu_t ** 2 + c1) * (var_p + var_t + c2))
    return torch.mean(s)


def lpips(pred, target, weights_path: str | None = None) -> torch.Tensor:
    """LPIPS of images in [0, 1] (torchmetrics' LPIPS with normalize=True,
    the reference's) on pred's device, with the weights at `weights_path`,
    else NERAF_LPIPS_WEIGHTS, else ~/.cache/neraf/lpips_{alex,vgg}.npz;
    NaN when none resolves, never another metric in its place."""
    from neraf_tpu_torch.metrics import lpips_impl

    path = weights_path or lpips_impl.resolve_default_weights()
    pred = torch.as_tensor(pred)
    if path is None:
        return torch.tensor(float("nan"))
    params, net = lpips_impl.load_device_params(str(path), str(pred.device))
    return lpips_impl.lpips_distance(params, pred, target, net=net)
