"""Learning-rate and time-noise schedules (reference utils/general_utils.py:42-75).

Counterpart of dgmesh_tpu/schedules.py: functions of the step, evaluated in
float32 on the step's device (a tensor step stays on its device, with no
host sync).
"""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32)


def expon_lr(step, lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0, max_steps: int = 1_000_000) -> torch.Tensor:
    """Log-linear interpolation with an optional delayed warm-up; 0 for a
    negative step or ``lr_init == 0`` (the reference's get_expon_lr_func)."""
    step = _f32(step)
    if lr_init == 0.0:
        return torch.zeros_like(step)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0, 1))
    else:
        delay_rate = 1.0
    t = torch.clamp(step / max_steps, 0, 1)
    log_lerp = torch.exp(math.log(lr_init) * (1 - t) + math.log(max(lr_final, 1e-30)) * t)
    return torch.where(step < 0, 0.0, delay_rate * log_lerp)


def linear_noise(step, lr_init: float = 0.1, lr_final: float = 1e-15,
                 lr_delay_mult: float = 0.01, max_steps: int = 20_000) -> torch.Tensor:
    """Time-noise magnitude (reference get_linear_noise_func, train.py:119):
    linear interpolation with the same sin-delay ramp."""
    step = _f32(step)
    delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
        0.5 * math.pi * torch.clamp(step / max_steps, 0, 1))
    t = torch.clamp(step / max_steps, 0, 1)
    return delay_rate * (lr_init * (1 - t) + lr_final * t)
