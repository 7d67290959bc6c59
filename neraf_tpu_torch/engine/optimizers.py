"""Optimizers and LR schedules (counterpart of neraf_tpu/engine/optimizers.py).

The reference trains four named Adam(eps=1e-15) groups, each under
nerfstudio's ExponentialDecayScheduler with an optional cosine warmup:

    step < warmup: lr_pre_warmup + (lr - lr_pre_warmup) sin(pi/2 step/warmup)
    else:          exp(log(lr) (1 - t) + log(lr_final) t),
                   t = clip((step - warmup) / (max_steps - warmup), 0, 1)

computed in float32 as the JAX package's optax schedule computes it. As
optax.scale_by_schedule counts, an update uses the schedule at the group's
own count of updates before it: the first update uses lr(0).
"""

from __future__ import annotations

import numpy as np
import torch

from neraf_tpu_torch.configs.config import OptimizerGroupConfig


def exponential_decay_schedule(lr_init: float, lr_final: float,
                               max_steps: int, warmup_steps: int = 0,
                               lr_pre_warmup: float = 1e-8,
                               ramp: str = "cosine"):
    """step (int) -> learning rate (float), evaluated in float32."""
    f32 = np.float32

    def schedule(step: int) -> float:
        step = f32(step)
        if step < warmup_steps:
            frac = np.clip(step / f32(warmup_steps), f32(0), f32(1))
            if ramp == "cosine":
                frac = np.sin(f32(0.5 * np.pi) * frac)
            return float(f32(lr_pre_warmup) + f32(lr_init - lr_pre_warmup)
                         * frac)
        t = np.clip((step - f32(warmup_steps)) / f32(max(max_steps - warmup_steps, 1)),
                    f32(0), f32(1))
        return float(np.exp(np.log(f32(lr_init)) * (f32(1) - t)
                            + np.log(f32(lr_final)) * t))

    return schedule


class ScheduledAdam:
    """One reference group: torch.optim.Adam(eps) whose learning rate is set
    from the schedule at the group's update count before every step; the
    fused (one-kernel) Adam when the parameters are on a card."""

    def __init__(self, params, cfg: OptimizerGroupConfig):
        self.params = list(params)
        self.schedule = exponential_decay_schedule(cfg.lr, cfg.lr_final,
                                                   cfg.max_steps,
                                                   cfg.warmup_steps)
        self.opt = torch.optim.Adam(self.params, lr=cfg.lr, eps=cfg.eps,
                                    fused=self.params[0].is_cuda)
        self.count = 0

    @property
    def lr(self) -> float:
        """The learning rate of the next update."""
        return self.schedule(self.count)

    def step(self) -> None:
        """One update. A parameter without a gradient steps with a zero one
        (as an optax group does), so every group's count stays in step."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        for group in self.opt.param_groups:
            group["lr"] = self.lr
        self.opt.step()
        self.count += 1
