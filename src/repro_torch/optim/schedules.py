"""Learning-rate schedules (own copy of ``repro/optim/schedules.py``):
pure functions of the step counter, computed on the counter's device so
a step needs no host sync.  Divisors are device tensors, so every
division is a true one on the card too."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import OptimizerConfig


def lr_at(cfg: OptimizerConfig, step) -> torch.Tensor:
    """fp32 0-d tensor on ``step``'s device (CPU for a Python number)."""
    step = torch.as_tensor(step).float()

    def const(x):
        return torch.tensor(float(x), dtype=torch.float32,
                            device=step.device)

    warm = torch.clamp(step / const(max(cfg.warmup_steps, 1)), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / const(max(cfg.total_steps - cfg.warmup_steps, 1)),
                       0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
            1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - (1 - cfg.min_lr_ratio) * frac
    else:
        decay = const(1.0)
    return cfg.lr * warm * decay
