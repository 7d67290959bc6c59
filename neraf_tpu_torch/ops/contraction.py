"""Scene contraction for unbounded scenes (counterpart of
neraf_tpu/ops/contraction.py): nerfstudio's SceneContraction(order=inf),

    contract(x) = x                               if ||x||_inf <= 1
                = (2 - 1/||x||_inf) * x/||x||_inf  otherwise,

mapping R^3 into the ball of radius 2, then (x + 2) / 4 into [0, 1]^3.
"""

from __future__ import annotations

import torch


def scene_contraction(x: torch.Tensor) -> torch.Tensor:
    """Apply the inf-norm scene contraction to (..., 3) positions."""
    mag = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-10)
    contracted = (2.0 - 1.0 / mag) * (x / mag)
    return torch.where(mag <= 1.0, x, contracted)


def contract_to_unit(x: torch.Tensor) -> torch.Tensor:
    """Contract, then map the radius-2 ball into the unit cube [0, 1]^3."""
    return (scene_contraction(x) + 2.0) / 4.0
