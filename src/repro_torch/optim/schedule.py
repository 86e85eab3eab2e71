"""LR schedules as pure step -> scale functions (multiply AdamW's base lr).

Port of ``src/repro/optim/schedule.py``.  ``step`` is an int or a 0-d
tensor; the scale is a 0-d fp32 tensor on the step's device (the CPU for
an int), computed in fp32 as the reference computes it.
"""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def cosine_schedule(step, total_steps: int, final_frac: float = 0.1
                    ) -> torch.Tensor:
    t = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return final_frac + (1 - final_frac) * cos


def linear_warmup_cosine(step, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1) -> torch.Tensor:
    s = _f32(step)
    warm = torch.clamp(s / max(warmup_steps, 1), 0.0, 1.0)
    t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                    0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return warm * cos
