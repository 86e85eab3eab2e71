"""Parameter initialisation from an explicit ``torch.Generator``.

Port of the initialisers of ``src/repro/models/params.py``.  ``jax.random``
keys become one :class:`Init` that carries a generator and a device; on the
``meta`` device it draws nothing, so a model's shapes cost no memory.  The
mesh and ``PartitionSpec`` resolution of the reference module is not
ported: the port serves on one card.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


class Init:
    """Where parameters are made and the generator that draws them."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 device="cpu"):
        self.device = torch.device(device)
        self.generator = generator

    def randn(self, shape: Sequence[int]) -> torch.Tensor:
        if self.device.type == "meta":
            return torch.empty(tuple(shape), device=self.device)
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self.device)

    def full(self, shape: Sequence[int], value: float,
             dtype: torch.dtype) -> torch.Tensor:
        return torch.full(tuple(shape), value, dtype=dtype,
                          device=self.device)


def normal_init(init: Init, shape, dtype, scale: Optional[float] = None,
                fan_in: Optional[int] = None) -> torch.Tensor:
    fi = fan_in if fan_in is not None else (
        shape[-2] if len(shape) >= 2 else shape[-1])
    std = scale if scale is not None else 1.0 / math.sqrt(max(fi, 1))
    # scaled in place: one fp32 temporary, not two (an expert stack of
    # deepseek-v3 is 15 GB in fp32)
    return init.randn(shape).mul_(std).to(dtype)


def embed_init(init: Init, shape, dtype, **_) -> torch.Tensor:
    return init.randn(shape).mul_(0.02).to(dtype)
